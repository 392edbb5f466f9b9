"""Model registry: config ``name`` -> ``nn.Module``.

Only DynUNet is ported; the other names of ``unet3d_tpu/models/registry.py``
raise with the list of what is still to port (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Dict

from unet3d_tpu_torch.models.dynunet import DynUNet

MODEL_REGISTRY: Dict[str, Any] = {"DynUNet": DynUNet}

# names the JAX package resolves that the port does not have yet
NOT_YET_PORTED = (
    "AHNet", "AHnet", "Ahnet", "AttentionUnet", "AutoEncoder", "AutoImplantUNet",
    "AutocastUNet", "BasicUNet", "BasicUNetPlusPlus", "BasicUnetPlusPlus",
    "Classifier", "ConvolutionalAutoEncoder", "Critic", "DenseNet",
    "DenseNet121", "DenseNet169", "DenseNet201", "DenseNet264", "DiNTS",
    "Discriminator", "EfficientNetBN", "FCN", "Generator", "GlobalNet",
    "GraphCMR", "HighResNet", "LabeledVariationalAutoEncoder", "LocalNet",
    "QuickNAT", "Quicknat", "RegUNet", "RegularizedBasicResNet",
    "RegularizedResNet", "Regressor", "ResNet", "ResNetWithDecoder1D",
    "SegResNet", "SegResNetDS", "SegResNetVAE", "SwinUNETR",
    "TopologyConstruction", "TopologyInstance", "TopologySearch", "UNETR",
    "UNet", "UNet3D", "VNet", "VQVAE", "VarAutoEncoder",
    "VariationalAutoEncoder", "ViT", "ViTAutoEnc", "resnet_101", "resnet_152",
    "resnet_18", "resnet_34", "resnet_50", "resnext_101_32x8d",
    "resnext_50_32x4d",
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
