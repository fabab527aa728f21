from .batch import BatchedLinMPC, stack_params, estimator_params
from .batch_explicit import BatchedExplicitMPC
from .batch_kf import BatchedKalman
from .batch_mhe import BatchedMHE
from .batch_nonlin import BatchedNonLinMPC
from .grouped import lane_ctrl
from .scenarios import random_cstr_controllers
