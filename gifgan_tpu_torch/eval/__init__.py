from gifgan_tpu_torch.eval.activation_analyzer import activation_distances

__all__ = ["activation_distances"]
