from recommendflow_tpu_torch.models.reranking.escm2 import Escm2, ESCM2
