"""Feature-spec enums and dtype maps.

Mirrors the config *surface* of the reference (config_parser/config_proto.py:5-42):
towers {null,user,ad,context,label}, deals {null,numeric,discrete,hashing,lookup,
image,embedding,token_id,bert_encode}, poolings {null,avg,min,max,sum,first,last,
cls}. Dtypes are numpy (the device never sees strings — see data/hashing.py).
"""
from __future__ import annotations

import enum

import numpy as np


class FeatureTower(enum.Enum):
    Null = "null"
    User = "user"
    Ad = "ad"
    Context = "context"
    Label = "label"


class FeatureDeal(enum.Enum):
    Null = "null"
    Numeric = "numeric"
    Discrete = "discrete"
    Hashing = "hashing"
    Lookup = "lookup"
    Image = "image"
    Embedding = "embedding"
    TokenId = "token_id"
    BertEncode = "bert_encode"


class FeaturePooling(enum.Enum):
    Null = "null"
    Avg = "avg"
    Min = "min"
    Max = "max"
    Sum = "sum"
    First = "first"
    Last = "last"
    # 'cls' == take first token position (used by token_id text features)
    Cls = "cls"


TYPE_INT = "int"
TYPE_FLOAT = "float"
TYPE_STR = "str"
SUPPORT_TYPE = (TYPE_INT, TYPE_FLOAT, TYPE_STR)

# host-side (record/pipeline) dtypes per declared feature type
TYPE_MAP = {
    TYPE_INT: np.int64,
    TYPE_FLOAT: np.float32,
    TYPE_STR: np.dtype("O"),  # python str, hashed host-side before device
}

# padding / missing-value sentinel per type (reference: -1 / "" / -1.0)
DEFAULT_MAP = {
    TYPE_INT: -1,
    TYPE_FLOAT: -1.0,
    TYPE_STR: "",
}

# deals that produce an embedding table
EMBEDDING_DEALS = (FeatureDeal.Hashing, FeatureDeal.Lookup, FeatureDeal.Discrete)
# deals whose embedding_dim field is forced to -1
# (image keeps its dim: it is the patch-projection output width)
NO_DIM_DEALS = (
    FeatureDeal.Numeric, FeatureDeal.Null, FeatureDeal.TokenId,
    FeatureDeal.Embedding, FeatureDeal.BertEncode,
)
