from .cocoeval import SIGMAS, COCOKeypointsEval, compute_oks_matrix
from .oks import K_I, VARIANCES, image_OKS, match_preds_to_targets, object_OKS
from .pckh import pckh

__all__ = [
    "K_I",
    "VARIANCES",
    "object_OKS",
    "image_OKS",
    "match_preds_to_targets",
    "COCOKeypointsEval",
    "compute_oks_matrix",
    "SIGMAS",
    "pckh",
]
