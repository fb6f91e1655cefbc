"""UNet backbones: the ConvNeXt family (``UnetConvNext``), the DDPM ResNet
family (``UnetResNet``), guided-diffusion's ADM (``UnetADM``) and
``get_model``, which picks one by name."""

from .get_model import get_model
from .unet_adm import UnetADM
from .unet_convnext import UnetConvNext
from .unet_resnet import UnetResNet

__all__ = ["UnetADM", "UnetConvNext", "UnetResNet", "get_model"]
