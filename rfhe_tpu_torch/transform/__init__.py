"""The four-step NTT as modular matmuls (`transform/four_step.py`) and the
sharded NTTs over a mesh axis (`distributed.py`, `mxu_sharded.py`)."""
