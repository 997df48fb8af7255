"""Quaternion kinematics and the contact springs (PyTorch)."""

from . import inertial, quat
from .quat import fk, fk_vel, ik
