"""Measurements of the port on the card (counterpart of `rfhe_tpu/bench`)."""
