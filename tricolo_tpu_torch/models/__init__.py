"""Encoders of the port (eval and train forward)."""

from .bigru import BiGRUEncoder
from .mvcnn import MVCNNEncoder
from .resnet import ResNet
from .tricolo_net import TriCoLoNet
from .voxel_cnn import VoxelCNNEncoder

__all__ = ["BiGRUEncoder", "MVCNNEncoder", "ResNet", "TriCoLoNet", "VoxelCNNEncoder"]
