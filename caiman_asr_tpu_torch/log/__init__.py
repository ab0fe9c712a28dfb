from caiman_asr_tpu_torch.log.logger import MetricLogger, init_log
from caiman_asr_tpu_torch.log.tee import tee_stdout_to_file
