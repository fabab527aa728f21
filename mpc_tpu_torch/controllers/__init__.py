from .base import PredictiveController, default_Hp, info2debugstr
from .transcription import (TranscriptionMethod, SingleShooting, MultipleShooting,
                            TrapezoidalCollocation, OrthogonalCollocation,
                            move_blocking, init_predmat, init_defectmat)
from .construct import ControllerWeights
from .linmpc import LinMPC
from .slmpc import SLMPC
from .nonlinmpc import NonLinMPC
from .explicitmpc import ExplicitMPC

__all__ = [
    "PredictiveController", "LinMPC", "ExplicitMPC", "NonLinMPC", "SLMPC",
    "TranscriptionMethod", "SingleShooting", "MultipleShooting",
    "TrapezoidalCollocation", "OrthogonalCollocation",
    "move_blocking", "ControllerWeights", "default_Hp",
]
