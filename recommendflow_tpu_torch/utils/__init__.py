from recommendflow_tpu_torch.utils.str_parser import (
    str2bool, str2debug, str2list, str2dict, str2scale, str2dayno, str2fn, str2loss,
)
from recommendflow_tpu_torch.utils.tables import format_table, print_table
from recommendflow_tpu_torch.utils.logger import get_logger
