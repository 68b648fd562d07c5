"""The baseline zoo (``edrl_tpu/baselines``): the comparison models and the
``--model_name`` registry."""

from edrl_tpu_torch.baselines.models import (
    CBAM2D,
    CBAM3D,
    MLC,
    FeatureExtractor2D,
    FeatureExtractor3D,
    FundusOnly2D,
    MLCTrans,
    MultiCBAMResNet,
    MultiDropoutResNet,
    MultiEFResNet,
    MultiEnsemble3DResNet,
    MultiEnsembleResNet,
    MultiResNet,
    MultiResNetCross,
    OctOnly3D,
    ThreeDTransformer,
    TransCross,
    TwoDTransformer,
)
from edrl_tpu_torch.baselines.registry import ENSEMBLE_LRS, MODEL_REGISTRY, build_baseline

__all__ = [
    "CBAM2D", "CBAM3D", "FeatureExtractor2D", "FeatureExtractor3D", "FundusOnly2D", "OctOnly3D",
    "MultiCBAMResNet", "MultiDropoutResNet", "MultiEFResNet", "MultiEnsembleResNet", "MultiEnsemble3DResNet",
    "MultiResNet", "MultiResNetCross", "TransCross", "TwoDTransformer", "ThreeDTransformer", "MLC", "MLCTrans",
    "ENSEMBLE_LRS", "MODEL_REGISTRY", "build_baseline",
]
