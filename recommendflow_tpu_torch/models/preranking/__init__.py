from recommendflow_tpu_torch.models.preranking.cold import Cold, COLD
