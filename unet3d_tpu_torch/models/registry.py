"""Model registry: config ``name`` -> ``nn.Module``.

Ported: DynUNet, the Myronenko family (SegResNet, SegResNetVAE, UNet3D,
AutocastUNet, AutoImplantUNet and the autoencoders), the BatchNorm
segmentation nets (SegResNetDS, AttentionUnet, MONAI's UNet, VNet), the
transformers (UNETR, SwinUNETR, ViT, ViTAutoEnc) and the MONAI conv stacks
without BatchNorm (BasicUNet, BasicUNetPlusPlus, Quicknat, DiNTS with its
topology spaces, which resolve by name as in JAX), and the last MONAI conv
nets: AutoEncoder, VarAutoEncoder, the Regressor / Classifier /
Discriminator / Critic / Generator heads, HighResNet, AHNet (also as AHnet
and Ahnet) and the registration nets RegUNet, GlobalNet and LocalNet; the
classifiers: ResNet with its ``resnet_*`` / ``resnext_*`` factories,
DenseNet with ``DenseNet121`` to ``264``, EfficientNetBN, the hybrids
RegularizedResNet, RegularizedBasicResNet and ResNetWithDecoder1D, and
the FCN; the two-level ``VQVAE`` and the mesh regressor ``GraphCMR``.
Every name of ``unet3d_tpu/models/registry.py`` resolves; another raises
with the list.
"""
from __future__ import annotations

from typing import Any, Dict

from unet3d_tpu_torch.models.ahnet import AHNet
from unet3d_tpu_torch.models.attentionunet import AttentionUnet
from unet3d_tpu_torch.models.basicunet import BasicUNet
from unet3d_tpu_torch.models.basicunetplusplus import BasicUNetPlusPlus
from unet3d_tpu_torch.models.custom import (RegularizedBasicResNet, RegularizedResNet,
                                            ResNetWithDecoder1D)
from unet3d_tpu_torch.models.densenet import (DenseNet, DenseNet121, DenseNet169,
                                              DenseNet201, DenseNet264)
from unet3d_tpu_torch.models.dints import DiNTS, TopologyInstance, TopologySearch
from unet3d_tpu_torch.models.dynunet import DynUNet
from unet3d_tpu_torch.models.efficientnet import EfficientNetBN
from unet3d_tpu_torch.models.fcn import FCN
from unet3d_tpu_torch.models.graph import GraphCMR
from unet3d_tpu_torch.models.highresnet import HighResNet
from unet3d_tpu_torch.models.monai_autoencoder import AutoEncoder, VarAutoEncoder
from unet3d_tpu_torch.models.monai_heads import (Classifier, Critic, Discriminator, Generator,
                                                 Regressor)
from unet3d_tpu_torch.models.monai_unet import UNet
from unet3d_tpu_torch.models.quicknat import Quicknat
from unet3d_tpu_torch.models.regunet import GlobalNet, LocalNet, RegUNet
from unet3d_tpu_torch.models import resnet
from unet3d_tpu_torch.models.segresnet import SegResNet, SegResNetVAE
from unet3d_tpu_torch.models.segresnet_ds import SegResNetDS
from unet3d_tpu_torch.models.swin_unetr import SwinUNETR
from unet3d_tpu_torch.models.unet import AutocastUNet, AutoImplantUNet, UNet3D
from unet3d_tpu_torch.models.unetr import UNETR
from unet3d_tpu_torch.models.variational import (ConvolutionalAutoEncoder,
                                                 LabeledVariationalAutoEncoder,
                                                 VariationalAutoEncoder)
from unet3d_tpu_torch.models.vit import ViT, ViTAutoEnc
from unet3d_tpu_torch.models.vqvae2 import VQVAE
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
    "AutoEncoder": AutoEncoder,
    "VarAutoEncoder": VarAutoEncoder,
    "Regressor": Regressor,
    "Classifier": Classifier,
    "Discriminator": Discriminator,
    "Critic": Critic,
    "Generator": Generator,
    "HighResNet": HighResNet,
    "AHNet": AHNet,
    "AHnet": AHNet,                           # MONAI's aliases
    "Ahnet": AHNet,
    "RegUNet": RegUNet,
    "GlobalNet": GlobalNet,
    "LocalNet": LocalNet,
    "DenseNet": DenseNet,
    "EfficientNetBN": EfficientNetBN,
    "ResNet": resnet.ResNet,
    "VQVAE": VQVAE,
    "FCN": FCN,
    "GraphCMR": GraphCMR,
    "RegularizedResNet": RegularizedResNet,
    "RegularizedBasicResNet": RegularizedBasicResNet,
    "ResNetWithDecoder1D": ResNetWithDecoder1D,
    # the factories (JAX's _FACTORIES)
    "DenseNet121": DenseNet121,
    "DenseNet169": DenseNet169,
    "DenseNet201": DenseNet201,
    "DenseNet264": DenseNet264,
    "resnet_18": resnet.resnet_18,
    "resnet_34": resnet.resnet_34,
    "resnet_50": resnet.resnet_50,
    "resnet_101": resnet.resnet_101,
    "resnet_152": resnet.resnet_152,
    "resnext_50_32x4d": resnet.resnext_50_32x4d,
    "resnext_101_32x8d": resnet.resnext_101_32x8d,
}

# names the JAX package resolves that the port does not have yet: none
NOT_YET_PORTED = ()


def create_model(model_name: str, /, **kwargs):
    """Instantiate a model from config-section kwargs (JSON lists accepted)."""
    if model_name not in MODEL_REGISTRY:
        raise ValueError(
            f"model name {model_name} is unknown; ported: "
            f"{', '.join(sorted(MODEL_REGISTRY))}")
    return MODEL_REGISTRY[model_name](**kwargs)
