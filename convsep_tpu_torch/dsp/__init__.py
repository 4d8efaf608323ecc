"""DSP: windows, framing, DFT-as-matmul STFT/iSTFT, masked resynthesis."""
