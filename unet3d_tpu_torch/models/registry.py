"""Model registry: config ``name`` -> ``nn.Module``.

Ported: DynUNet, the Myronenko family (SegResNet, SegResNetVAE, UNet3D,
AutocastUNet, AutoImplantUNet and the autoencoders), the BatchNorm
segmentation nets (SegResNetDS, AttentionUnet, MONAI's UNet, VNet), the
transformers (UNETR, SwinUNETR, ViT, ViTAutoEnc) and the MONAI conv stacks
without BatchNorm (BasicUNet, BasicUNetPlusPlus, Quicknat, DiNTS with its
topology spaces, which resolve by name as in JAX). The other names of
``unet3d_tpu/models/registry.py`` raise with the list of what is still to
port (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Dict

from unet3d_tpu_torch.models.attentionunet import AttentionUnet
from unet3d_tpu_torch.models.basicunet import BasicUNet
from unet3d_tpu_torch.models.basicunetplusplus import BasicUNetPlusPlus
from unet3d_tpu_torch.models.dints import DiNTS, TopologyInstance, TopologySearch
from unet3d_tpu_torch.models.dynunet import DynUNet
from unet3d_tpu_torch.models.monai_unet import UNet
from unet3d_tpu_torch.models.quicknat import Quicknat
from unet3d_tpu_torch.models.segresnet import SegResNet, SegResNetVAE
from unet3d_tpu_torch.models.segresnet_ds import SegResNetDS
from unet3d_tpu_torch.models.swin_unetr import SwinUNETR
from unet3d_tpu_torch.models.unet import AutocastUNet, AutoImplantUNet, UNet3D
from unet3d_tpu_torch.models.unetr import UNETR
from unet3d_tpu_torch.models.variational import (ConvolutionalAutoEncoder,
                                                 LabeledVariationalAutoEncoder,
                                                 VariationalAutoEncoder)
from unet3d_tpu_torch.models.vit import ViT, ViTAutoEnc
from unet3d_tpu_torch.models.vnet import VNet

MODEL_REGISTRY: Dict[str, Any] = {
    "DynUNet": DynUNet,
    "SegResNet": SegResNet,
    "SegResNetVAE": SegResNetVAE,
    "UNet3D": UNet3D,
    "AutocastUNet": AutocastUNet,
    "AutoImplantUNet": AutoImplantUNet,
    "ConvolutionalAutoEncoder": ConvolutionalAutoEncoder,
    "VariationalAutoEncoder": VariationalAutoEncoder,
    "LabeledVariationalAutoEncoder": LabeledVariationalAutoEncoder,
    "SegResNetDS": SegResNetDS,
    "AttentionUnet": AttentionUnet,
    "UNet": UNet,
    "VNet": VNet,
    "UNETR": UNETR,
    "SwinUNETR": SwinUNETR,
    "ViT": ViT,
    "ViTAutoEnc": ViTAutoEnc,
    "BasicUNet": BasicUNet,
    "BasicUNetPlusPlus": BasicUNetPlusPlus,
    "BasicUnetPlusPlus": BasicUNetPlusPlus,   # MONAI exports both casings
    "Quicknat": Quicknat,
    "QuickNAT": Quicknat,
    "DiNTS": DiNTS,
    "TopologyInstance": TopologyInstance,     # the search spaces resolve by
    "TopologySearch": TopologySearch,         # name, as in JAX
    "TopologyConstruction": TopologyInstance,  # MONAI's base-class name
}

# names the JAX package resolves that the port does not have yet
NOT_YET_PORTED = (
    "AHNet", "AHnet", "Ahnet", "AutoEncoder", "Classifier", "Critic",
    "DenseNet", "DenseNet121", "DenseNet169", "DenseNet201", "DenseNet264",
    "Discriminator", "EfficientNetBN", "FCN", "Generator",
    "GlobalNet", "GraphCMR", "HighResNet", "LocalNet",
    "RegUNet", "RegularizedBasicResNet", "RegularizedResNet", "Regressor",
    "ResNet", "ResNetWithDecoder1D", "VQVAE", "VarAutoEncoder",
    "resnet_101", "resnet_152", "resnet_18", "resnet_34", "resnet_50",
    "resnext_101_32x8d", "resnext_50_32x4d",
)


def create_model(model_name: str, /, **kwargs):
    """Instantiate a model from config-section kwargs (JSON lists accepted)."""
    if model_name not in MODEL_REGISTRY:
        state = ("is not ported to PyTorch yet" if model_name in NOT_YET_PORTED
                 else "is unknown")
        raise ValueError(
            f"model name {model_name} {state}; ported: "
            f"{', '.join(sorted(MODEL_REGISTRY))}; still to port: "
            f"{', '.join(NOT_YET_PORTED)}")
    return MODEL_REGISTRY[model_name](**kwargs)
