"""Spectrogram segmentation."""
