"""The four-step NTT as modular matmuls (`transform/four_step.py`)."""
