"""Training: losses, Lasagne adadelta (plain and the fused CUDA kernel), the
from-audio training step and the ``Trainer`` loop."""
