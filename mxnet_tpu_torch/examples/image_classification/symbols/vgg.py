"""VGG 11/13/16/19, with BatchNorm under ``batch_norm`` (the port's copy of
``examples/image-classification/symbols/vgg.py``; reference
symbols/vgg.py)."""
from mxnet_tpu_torch import sym

vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False, dtype="float32", **kwargs):
    if num_layers not in vgg_spec:
        raise ValueError("invalid num_layers %d: choose from %s" % (num_layers, sorted(vgg_spec)))
    layers, filters = vgg_spec[num_layers]
    data = sym.Variable("data")
    if dtype == "float16":
        data = sym.cast(data, dtype="float16")
    body = data
    for i, num in enumerate(layers):
        for j in range(num):
            body = sym.Convolution(body, kernel=(3, 3), pad=(1, 1), num_filter=filters[i],
                                   name="conv%d_%d" % (i + 1, j + 1))
            if batch_norm:
                body = sym.BatchNorm(body, name="bn%d_%d" % (i + 1, j + 1))
            body = sym.Activation(body, act_type="relu", name="relu%d_%d" % (i + 1, j + 1))
        body = sym.Pooling(body, pool_type="max", kernel=(2, 2), stride=(2, 2),
                           name="pool%d" % (i + 1))
    flatten = sym.Flatten(body, name="flatten")
    fc6 = sym.FullyConnected(flatten, num_hidden=4096, name="fc6")
    relu6 = sym.Activation(fc6, act_type="relu", name="relu6")
    drop6 = sym.Dropout(relu6, p=0.5, name="drop6")
    fc7 = sym.FullyConnected(drop6, num_hidden=4096, name="fc7")
    relu7 = sym.Activation(fc7, act_type="relu", name="relu7")
    drop7 = sym.Dropout(relu7, p=0.5, name="drop7")
    fc8 = sym.FullyConnected(drop7, num_hidden=num_classes, name="fc8")
    if dtype == "float16":
        fc8 = sym.cast(fc8, dtype="float32")
    return sym.SoftmaxOutput(fc8, name="softmax")
