"""The port's version (the counterpart of `recommendflow_tpu/version.py`)."""
__version__ = "0.1.0"
