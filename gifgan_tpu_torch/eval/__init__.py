from gifgan_tpu_torch.eval.track_rate import face_track_rate, track_rate_report
from gifgan_tpu_torch.eval.activation_analyzer import activation_distances
from gifgan_tpu_torch.eval.survey import export_survey_samples

__all__ = ["face_track_rate", "track_rate_report", "activation_distances",
           "export_survey_samples"]
