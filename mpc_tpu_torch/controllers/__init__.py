from .base import PredictiveController, default_Hp, info2debugstr
from .transcription import (SingleShooting, MultipleShooting,
                            move_blocking, init_predmat, init_defectmat)
from .construct import ControllerWeights
from .linmpc import LinMPC
from .slmpc import SLMPC

__all__ = [
    "PredictiveController", "LinMPC", "SLMPC", "SingleShooting", "MultipleShooting",
    "move_blocking", "ControllerWeights", "default_Hp",
]
