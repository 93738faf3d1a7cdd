"""The port's copy of ``examples/image-classification``: ``train_imagenet``,
``train_mnist``, ``common/fit.py`` and ``common/data.py``, and the
``symbols`` (AlexNet, LeNet, MLP, VGG, ResNet)."""
