from .anchor import batch_kmeans_fit, generate_anchors, kmeans_fit, kmeans_predict, refine
from .descriptor import (ETBasis, fit_basis, project, reconstruct, reconstruct_norm,
                         truncated_svd)
from .facade import ETParams, calculate_parameters, et_forward, moving_mask
from .normalizer import NormParams, compute_norm_params, denormalize, normalize
