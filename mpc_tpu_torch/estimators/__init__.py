from .base import StateEstimator
from .construct import (augment_model, default_nint, init_estimstoch,
                        init_integrators)
from .kalman import (ExtendedKalmanFilter, KalmanFilter, SteadyKalmanFilter,
                     UnscentedKalmanFilter)
from .luenberger import Luenberger
from .internal_model import InternalModel
from .manual import ManualEstimator
from .mhe import MovingHorizonEstimator

__all__ = [
    "StateEstimator", "SteadyKalmanFilter", "KalmanFilter",
    "UnscentedKalmanFilter", "ExtendedKalmanFilter", "Luenberger",
    "InternalModel", "ManualEstimator", "MovingHorizonEstimator",
    "default_nint", "init_estimstoch", "init_integrators", "augment_model",
]
