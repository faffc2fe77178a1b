"""vgg2016 in PyTorch (NCHW ``nn.Module``s, reference ``state_dict``
names). Build it with :func:`torch_ekpose_tpu_torch.models.factory.get_model`
or ``init_model``."""
