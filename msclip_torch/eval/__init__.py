from .checkpoint_load import load_model_params
from .zero_shot import build_zeroshot_classifier, make_dataset, run_zero_shot

__all__ = [
    "build_zeroshot_classifier",
    "load_model_params",
    "make_dataset",
    "run_zero_shot",
]
