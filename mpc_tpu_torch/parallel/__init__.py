from .batch import BatchedLinMPC, stack_params, estimator_params
from .batch_kf import BatchedKalman
from .grouped import lane_ctrl
from .scenarios import random_cstr_controllers
