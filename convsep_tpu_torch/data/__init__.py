"""Data: spectrogram segmentation, wav I/O, synthetic fixtures, the
from-audio training dataset and the device prefetch."""
