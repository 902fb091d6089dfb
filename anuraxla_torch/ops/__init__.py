"""Frontend ops of the port: mel math, STFT oracle, the fused mel kernel."""
