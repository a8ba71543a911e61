from vqwild_tpu_torch.models.resnet_f2f import ResNet18F2F

__all__ = ["ResNet18F2F"]
