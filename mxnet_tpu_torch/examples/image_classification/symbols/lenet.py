"""LeNet-5 style convnet, with a spatial transformer in front under
``add_stn`` (the port's copy of ``examples/image-classification/symbols/
lenet.py``; reference symbols/lenet.py).

The transformer is the reference's: ``SpatialTransformer`` of the data by
the six affine parameters of a localisation layer (here the JAX copy's one
dense layer, ``stn_loc``), to a 28x28 target, sampled bilinearly, the
layer at the reference's learning-rate multiplier 0.01.  The layer starts
at the identity transform (weight 0, bias (1, 0, 0, 0, 1, 0)): from the
default Xavier draw its transform maps most of each image outside the
28x28 window and the net does not learn.  The JAX copy passes the
``GridGenerator`` output as the location and ``transform_type="bilinear"``
without a ``target_shape``, which its op rejects, so that symbol does not
build."""
from mxnet_tpu_torch import init, sym

IDENTITY = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def get_symbol(num_classes=10, add_stn=False, **kwargs):
    data = sym.Variable("data")
    if add_stn:
        lr_mult = {"__lr_mult__": "0.01"}
        loc = sym.FullyConnected(
            sym.Flatten(data), num_hidden=6, name="stn_loc",
            weight=sym.Variable("stn_loc_weight", attr=lr_mult, init=init.Zero()),
            bias=sym.Variable("stn_loc_bias", attr=lr_mult, init=init.Constant(IDENTITY)))
        data = sym.SpatialTransformer(data, loc, target_shape=(28, 28),
                                      transform_type="affine", sampler_type="bilinear",
                                      name="stn")
    conv1 = sym.Convolution(data, kernel=(5, 5), num_filter=20, name="conv1")
    tanh1 = sym.Activation(conv1, act_type="tanh")
    pool1 = sym.Pooling(tanh1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    conv2 = sym.Convolution(pool1, kernel=(5, 5), num_filter=50, name="conv2")
    tanh2 = sym.Activation(conv2, act_type="tanh")
    pool2 = sym.Pooling(tanh2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    flatten = sym.Flatten(pool2)
    fc1 = sym.FullyConnected(flatten, num_hidden=500, name="fc1")
    tanh3 = sym.Activation(fc1, act_type="tanh")
    fc2 = sym.FullyConnected(tanh3, num_hidden=num_classes, name="fc2")
    return sym.SoftmaxOutput(fc2, name="softmax")
