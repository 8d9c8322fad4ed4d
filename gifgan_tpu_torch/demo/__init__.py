from gifgan_tpu_torch.demo.derive import (derive_paths, load_trajectories,
                                          pca_directions, score_trajectory,
                                          smooth_path)
from gifgan_tpu_torch.demo.paths import (EXPRESSIONS, make_expression_paths,
                                         write_paths)

__all__ = ["EXPRESSIONS", "make_expression_paths", "write_paths",
           "derive_paths", "load_trajectories", "pca_directions",
           "score_trajectory", "smooth_path"]
