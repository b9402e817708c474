from recommendflow_tpu_torch.config.proto import (
    FeatureTower, FeatureDeal, FeaturePooling,
    TYPE_INT, TYPE_FLOAT, TYPE_STR, SUPPORT_TYPE, TYPE_MAP, DEFAULT_MAP,
)
from recommendflow_tpu_torch.config.features import Feature, Features, load_slot_map
from recommendflow_tpu_torch.config.configuration import Configuration
