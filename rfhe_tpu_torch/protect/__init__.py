"""ABFT detectors of the port: fold checksums, the check library and the NTT
projection guard (counterpart of `rfhe_tpu/protect`)."""
