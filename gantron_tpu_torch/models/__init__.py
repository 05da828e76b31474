from gantron_tpu_torch.models.tacotron2 import Tacotron2  # noqa: F401
