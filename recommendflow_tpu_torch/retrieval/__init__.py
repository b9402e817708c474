from recommendflow_tpu_torch.retrieval.searcher import (
    FlatSearcher, IvfPqSearcher, IvfSearcher, PqSearcher, SqSearcher,
    index_factory, kmeans, resolve_metric,
)
from recommendflow_tpu_torch.retrieval.host_tier import (HostIvfSearcher,
                                                        StreamingSqSearcher)
from recommendflow_tpu_torch.retrieval.encoder_search import EncoderSearcher
from recommendflow_tpu_torch.retrieval.whitening import VecsWhitening
from recommendflow_tpu_torch.retrieval.eval import (
    batch_compute_group_recall_score, batch_compute_recall_score, click_ranks,
    hit_at_k, make_recall_evaluator, mrr_at_k, ndcg_at_k, recall_metrics,
    recall_report,
)
