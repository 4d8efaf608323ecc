"""Data: wav, tensor-feature and pickle files, spectrogram segmentation,
synthetic fixtures, offline feature computation, the feature-file and
from-audio training datasets (with the native batch gather) and the device
prefetch."""
