"""The benchmark's plain reference: float32 PyTorch of the blocks the
configurations use, their loss and AdamW.  It imports nothing of the system
under test; the benchmark hands it the same weights and inputs."""
