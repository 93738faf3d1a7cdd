"""Pre-activation ResNet (v2, "Identity Mappings in Deep Residual Networks")
as a Symbol: the port's copy of ``examples/image-classification/symbols/
resnet.py`` (reference example/image-classification/symbols/resnet.py),
built on ``mxnet_tpu_torch.symbol``, with the same node and parameter names.

Depths as the reference's: CIFAR-style 3-stage nets for images of height
<= 32 (9n+2 bottleneck or 6n+2 basic layers), ImageNet-style 4-stage nets
(18/34/50/101/152/200/269).  ``get_symbol(1000, 50, "3,224,224")`` is the
ResNet-50 v2 that upstream's imagenet_gen_qsym.py quantizes.
"""
from .. import symbol as sym

__all__ = ["get_symbol", "resnet", "residual_unit"]


def residual_unit(data, num_filter, stride, dim_match, name, bottle_neck=True,
                  bn_mom=0.9, workspace=256, memonger=False):
    """One pre-act residual unit: BN-ReLU-Conv stack + identity shortcut."""
    eps = 2e-5
    if bottle_neck:
        bn1 = sym.BatchNorm(data, fix_gamma=False, eps=eps, momentum=bn_mom, name=name + "_bn1")
        act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(act1, num_filter=num_filter // 4, kernel=(1, 1), stride=(1, 1),
                                pad=(0, 0), no_bias=True, workspace=workspace, name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=eps, momentum=bn_mom, name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(act2, num_filter=num_filter // 4, kernel=(3, 3), stride=stride,
                                pad=(1, 1), no_bias=True, workspace=workspace, name=name + "_conv2")
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, eps=eps, momentum=bn_mom, name=name + "_bn3")
        act3 = sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        conv3 = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1), stride=(1, 1),
                                pad=(0, 0), no_bias=True, workspace=workspace, name=name + "_conv3")
        shortcut = data if dim_match else sym.Convolution(
            act1, num_filter=num_filter, kernel=(1, 1), stride=stride, no_bias=True,
            workspace=workspace, name=name + "_sc")
        return conv3 + shortcut
    bn1 = sym.BatchNorm(data, fix_gamma=False, eps=eps, momentum=bn_mom, name=name + "_bn1")
    act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3), stride=stride,
                            pad=(1, 1), no_bias=True, workspace=workspace, name=name + "_conv1")
    bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=eps, momentum=bn_mom, name=name + "_bn2")
    act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
    conv2 = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3), stride=(1, 1),
                            pad=(1, 1), no_bias=True, workspace=workspace, name=name + "_conv2")
    shortcut = data if dim_match else sym.Convolution(
        act1, num_filter=num_filter, kernel=(1, 1), stride=stride, no_bias=True,
        workspace=workspace, name=name + "_sc")
    return conv2 + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, bn_mom=0.9, workspace=256, dtype="float32", memonger=False):
    num_unit = len(units)
    assert num_unit == num_stages
    if dtype != "float32":
        raise NotImplementedError("resnet: dtype %r is not ported (no cast op)" % dtype)
    data = sym.Variable("data")
    nchannel, height, width = image_shape
    eps = 2e-5
    data = sym.BatchNorm(data, fix_gamma=True, eps=eps, momentum=bn_mom, name="bn_data")
    if height <= 32:  # CIFAR
        body = sym.Convolution(data, num_filter=filter_list[0], kernel=(3, 3), stride=(1, 1),
                               pad=(1, 1), no_bias=True, name="conv0", workspace=workspace)
    else:  # ImageNet
        body = sym.Convolution(data, num_filter=filter_list[0], kernel=(7, 7), stride=(2, 2),
                               pad=(3, 3), no_bias=True, name="conv0", workspace=workspace)
        body = sym.BatchNorm(body, fix_gamma=False, eps=eps, momentum=bn_mom, name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max")

    for i in range(num_stages):
        stride = (1, 1) if i == 0 else (2, 2)
        body = residual_unit(body, filter_list[i + 1], stride, False,
                             name="stage%d_unit%d" % (i + 1, 1), bottle_neck=bottle_neck,
                             workspace=workspace, memonger=memonger)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name="stage%d_unit%d" % (i + 1, j + 2),
                                 bottle_neck=bottle_neck, workspace=workspace, memonger=memonger)
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=eps, momentum=bn_mom, name="bn1")
    relu1 = sym.Activation(bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7), pool_type="avg", name="pool1")
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")


def get_symbol(num_classes, num_layers, image_shape, conv_workspace=256,
               dtype="float32", **kwargs):
    """Depth → config table (reference symbols/resnet.py get_symbol)."""
    image_shape = [int(x) for x in image_shape.split(",")] if isinstance(image_shape, str) else list(image_shape)
    nchannel, height, width = image_shape
    if height <= 32:  # CIFAR
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        else:
            raise ValueError("no experiments done on num_layers %d" % num_layers)
        units = per_unit * num_stages
    else:  # ImageNet
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False
        num_stages = 4
        units_by_depth = {
            18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
            101: [3, 4, 23, 3], 152: [3, 8, 36, 3], 200: [3, 24, 36, 3],
            269: [3, 30, 48, 8],
        }
        if num_layers not in units_by_depth:
            raise ValueError("no experiments done on num_layers %d" % num_layers)
        units = units_by_depth[num_layers]

    return resnet(units=units, num_stages=num_stages, filter_list=filter_list,
                  num_classes=num_classes, image_shape=image_shape,
                  bottle_neck=bottle_neck, workspace=conv_workspace, dtype=dtype)
