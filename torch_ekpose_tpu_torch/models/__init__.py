"""The OpenPose networks in PyTorch (NCHW ``nn.Module``s, reference
``state_dict`` names): vgg2016 and the MobileNet, MobileNetV2 and
ShuffleNetV2 variants. Build one with
:func:`torch_ekpose_tpu_torch.models.factory.get_model` or ``init_model``."""
