from recommendflow_tpu_torch.models.ranking.dnn import Dnn, DNN
from recommendflow_tpu_torch.models.ranking.dcn import Dcn, DCN
from recommendflow_tpu_torch.models.ranking.deepfm import (DeepFm, DeepFM,
                                                           XDeepFm, XDeepFM)
from recommendflow_tpu_torch.models.ranking.mmoe import Mmoe, MMoE
from recommendflow_tpu_torch.models.ranking.essm import Essm, ESSM, Esmm
from recommendflow_tpu_torch.models.ranking.din import Din, DIN
from recommendflow_tpu_torch.models.ranking.tabtransformer import TabTransformer
from recommendflow_tpu_torch.models.ranking.esim import Esim
from recommendflow_tpu_torch.models.ranking.dlrm import DlrmDcnV2
