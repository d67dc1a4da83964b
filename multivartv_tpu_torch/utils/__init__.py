"""Utilities of the port: logging, metrics, checkpoints, profiling and the
roofline model."""
from multivartv_tpu_torch.utils.metrics import mse
