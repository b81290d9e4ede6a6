from ctts_tpu_torch.parallel.batch import BatchSynthesizer
from ctts_tpu_torch.parallel.mesh import make_mesh
