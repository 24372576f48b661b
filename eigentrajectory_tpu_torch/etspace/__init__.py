from .anchor import refine
from .descriptor import ETBasis, project, reconstruct, reconstruct_norm
from .facade import ETParams, et_forward, moving_mask
from .normalizer import NormParams, compute_norm_params, denormalize, normalize
