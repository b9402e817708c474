"""Model export for serving: `torch.export` programs that run the port's
kernels as custom ops (`exporter.py`)."""
from recommendflow_tpu_torch.export.exporter import (ServingModel,
                                                     custom_op_nodes,
                                                     export_model,
                                                     save_export, trace_model)
