"""The figure pipeline (counterpart of `rfhe_tpu/figures`): host matplotlib
over the sweeps' CSVs.  matplotlib is imported here only; no other module
of the port needs it."""
