from recommendflow_tpu_torch.models.matching.dssm import Dssm, TwoTower
from recommendflow_tpu_torch.models.matching.que2search import Que2Search
from recommendflow_tpu_torch.models.matching.siamese_encoder import SiameseEncoder
from recommendflow_tpu_torch.models.matching.dssm_encoder import DssmEncoder
from recommendflow_tpu_torch.models.matching.mobius import Mobius
from recommendflow_tpu_torch.models.matching.pdm import Pdm
