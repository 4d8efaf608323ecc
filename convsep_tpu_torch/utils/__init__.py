"""Device resolution and PCM helpers."""
