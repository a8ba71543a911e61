from vqwild_tpu_torch.models.arv import ARVModel, ModelOutput, build_model, init_model
from vqwild_tpu_torch.models.resnet_f2f import ResNet18F2F

__all__ = ["ARVModel", "ModelOutput", "ResNet18F2F", "build_model", "init_model"]
