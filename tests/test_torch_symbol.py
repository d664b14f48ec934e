"""PyTorch port: ``Symbol`` and its graph JSON against the JAX package's.

- The op registries agree: every op the port registers has the reference
  registry's canonical name and alias set (the JSON records the canonical
  name: ``Flatten`` -> ``flatten``, ``a + b`` -> ``elemwise_add``).
- ``tojson()`` bytes are equal for the example symbols (mlp, lenet, the
  ResNet at cifar depth 20 and imagenet depth 50), each package building
  ``example/image-classification/symbols/*.py`` under a fresh
  ``NameManager``; ``chip_smoke._example_resnet_symbol`` writes the
  example's bytes; ``load_json`` of either package's JSON followed by the
  other's ``tojson`` gives the same bytes.
- ``list_arguments``/``list_outputs``/``list_auxiliary_states``,
  ``get_internals``, ``get_children``, ``attr_dict``, ``infer_shape``,
  ``infer_shape_partial`` (0 dims) and ``infer_type`` match; arithmetic
  and scalar operators write the same JSON; shape errors are
  ``MXNetError``s.
"""
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.registry import OP_REGISTRY as JOPS
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.registry import OP_REGISTRY as TOPS

import chip_smoke

EXAMPLES = "example/image-classification/symbols/"
SYMBOLS = {
    "mlp": ("mlp.py", dict(num_classes=10)),
    "lenet": ("lenet.py", dict(num_classes=10)),
    "resnet20": ("resnet.py", dict(num_classes=10, num_layers=20,
                                   image_shape="3,32,32")),
    "resnet50": ("resnet.py", dict(num_classes=1000, num_layers=50,
                                   image_shape="3,224,224")),
}


def example_symbol(pkg, fname, **kw):
    """``get_symbol(**kw)`` of an example symbol file built against
    ``pkg`` (the file's own source, its package import swapped), under a
    fresh ``NameManager``."""
    with open(EXAMPLES + fname) as f:
        src = f.read()
    if pkg is tmx:
        src = src.replace("import mxnet_tpu as mx",
                          "import mxnet_tpu_torch as mx")
    ns = {}
    exec(compile(src, fname, "exec"), ns)
    with pkg.name.NameManager():
        return ns["get_symbol"](**kw)


def _both(name):
    fname, kw = SYMBOLS[name]
    return example_symbol(jmx, fname, **kw), example_symbol(tmx, fname, **kw)


def test_registries_agree():
    assert len(TOPS) > 100
    for key, op in TOPS.items():
        assert key in JOPS, key
        assert op.name == JOPS[key].name, key
        assert set(op.aliases) == set(JOPS[key].aliases), key


@pytest.mark.parametrize("name", sorted(SYMBOLS))
def test_example_json_bytes(name):
    js, ts = _both(name)
    assert ts.tojson() == js.tojson()


@pytest.mark.parametrize("name", ["resnet20", "resnet50"])
def test_chip_smoke_resnet_symbol_is_the_example(name):
    fname, kw = SYMBOLS[name]
    js = example_symbol(jmx, fname, **kw)
    assert chip_smoke._example_resnet_symbol(**kw).tojson() == js.tojson()


@pytest.mark.parametrize("name", ["mlp", "resnet20"])
def test_load_json_round_trips_both_ways(name, tmp_path):
    js, ts = _both(name)
    text = js.tojson()
    assert tmx.sym.load_json(text).tojson() == text
    assert jmx.sym.load_json(ts.tojson()).tojson() == text
    path = str(tmp_path / "net-symbol.json")
    ts.save(path)
    assert jmx.sym.load(path).tojson() == text
    assert tmx.sym.load(path).tojson() == text


def test_reference_mxnet_json_loads():
    # a stock MXNet 1.x file: bare-string attributes, 2-element entries,
    # node_row_ptr
    text = """{"nodes": [
      {"op": "null", "name": "data", "inputs": []},
      {"op": "null", "name": "fc_weight", "inputs": []},
      {"op": "null", "name": "fc_bias", "inputs": []},
      {"op": "FullyConnected", "name": "fc",
       "attrs": {"num_hidden": "3", "no_bias": "False"},
       "inputs": [[0, 0], [1, 0], [2, 0]]},
      {"op": "Activation", "name": "act", "attrs": {"act_type": "relu"},
       "inputs": [[3, 0]]}],
      "arg_nodes": [0, 1, 2], "node_row_ptr": [0, 1, 2, 3, 4, 5],
      "heads": [[4, 0]]}"""
    js, ts = jmx.sym.load_json(text), tmx.sym.load_json(text)
    assert ts.tojson() == js.tojson()
    assert ts.infer_shape(data=(2, 5)) == js.infer_shape(data=(2, 5))
    # a graph with an op the port has not registered is refused by name;
    # one with the int8 quantized ops loads
    unported = text.replace('"op": "Activation"', '"op": "_sample_uniform"')
    with pytest.raises(MXNetError, match="_sample_uniform"):
        tmx.sym.load_json(unported)
    quantized = text.replace('"op": "Activation"',
                             '"op": "_tpumx_quantized_fc_int8"')
    assert tmx.sym.load_json(quantized).tojson() == \
        jmx.sym.load_json(quantized).tojson()


@pytest.mark.parametrize("name", sorted(SYMBOLS))
def test_listing_and_inference(name):
    js, ts = _both(name)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_inputs() == js.list_inputs()
    assert ts.get_internals().list_outputs() == \
        js.get_internals().list_outputs()
    assert ts.attr_dict() == js.attr_dict()
    shape = (2, 1, 28, 28) if name in ("mlp", "lenet") else \
        (2, 3, 32, 32) if name == "resnet20" else (1, 3, 224, 224)
    assert ts.infer_shape(data=shape) == js.infer_shape(data=shape)
    assert ts.infer_type(data="float32") == js.infer_type(data="float32")
    assert ts.infer_shape_partial() == js.infer_shape_partial()


def _compose(pkg):
    sym = pkg.sym
    with pkg.name.NameManager():
        a = sym.Variable("a", shape=(2, 3), lr_mult=0.5, wd_mult=0.0)
        b = sym.Variable("b")
        with pkg.attribute.AttrScope(group="g1"):
            c = (a + b) * 2.0 - 1 / (a - 3) + (-b) ** 2
            d = sym.relu(c, name="r") / b
        e = 5.0 - d
        f = sym.Group([e > 0.5, a <= b, sym.sum(a * b, axis=1),
                       a.reshape((3, 2)), b.transpose(),
                       sym.Convolution(sym.Variable("x"), num_filter=4,
                                       kernel=(3, 3), pad=(1, 1),
                                       no_bias=True),
                       sym.BatchNorm(sym.Variable("y"), fix_gamma=False,
                                     attr={"k": "v"}),
                       sym.Pooling(sym.Variable("z"), kernel=(2, 2),
                                   stride=(2, 2), pool_type="avg"),
                       sym.split(sym.Variable("s"), num_outputs=2, axis=1)])
    return f


def test_composition_and_attributes():
    jf, tf = _compose(jmx), _compose(tmx)
    assert tf.tojson() == jf.tojson()
    assert tf.list_outputs() == jf.list_outputs()
    assert tf.attr_dict() == jf.attr_dict()
    ji, ti = jf.get_internals(), tf.get_internals()
    assert ti.list_outputs() == ji.list_outputs()
    assert ti["r_output"].attr("group") == "g1"
    assert ti["r_output"].get_children().list_outputs() == \
        ji["r_output"].get_children().list_outputs()
    shapes = dict(a=(2, 3), b=(2, 3), x=(1, 2, 5, 5), y=(1, 3, 4, 4),
                  z=(1, 2, 4, 4), s=(2, 4))
    assert tf.infer_shape(**shapes) == jf.infer_shape(**shapes)
    assert tf.infer_type(a="float16") == jf.infer_type(a="float16")


def test_infer_shape_partial_and_backward_fill():
    def net(pkg):
        with pkg.name.NameManager():
            d = pkg.sym.Variable("data")
            h = pkg.sym.Convolution(pkg.sym.Variable("img"), num_filter=4,
                                    kernel=(3, 3), name="conv") + 0
            return pkg.sym.Group([pkg.sym.FullyConnected(
                d, num_hidden=5, name="fc1"), h])

    jn, tn = net(jmx), net(tmx)
    # data's feature dim given as 0 (unknown): filled from the weight
    kw = dict(data=(4, 0), fc1_weight=(5, 7), img=(2, 0, 6, 6),
              conv_weight=(4, 3, 3, 3))
    assert tn.infer_shape(**kw) == jn.infer_shape(**kw)
    assert tn.infer_shape_partial(data=(4, 7)) == \
        jn.infer_shape_partial(data=(4, 7))


def test_infer_shape_errors():
    for pkg in (jmx, tmx):
        with pkg.name.NameManager():
            fc = pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                        num_hidden=3, name="fc")
        with pytest.raises(pkg.base.MXNetError, match="fc_weight"):
            fc.infer_shape(data=(2, 4), fc_weight=(3, 5))
        with pytest.raises(pkg.base.MXNetError, match="unknown shape"):
            fc.infer_shape()
    with tmx.name.NameManager():
        pool = tmx.sym.Pooling(tmx.sym.Variable("data"), kernel=(7, 7),
                               name="p")
    # an op that raises inside inference reports the reference's error
    with pytest.raises(MXNetError, match="infer_shape failed at op 'p'"):
        pool.infer_shape(data=(1, 1, 5, 5))


def test_auto_names_follow_the_reference_counters():
    def names(pkg):
        with pkg.name.NameManager():
            x = pkg.sym.Variable("x")
            for _ in range(3):
                x = pkg.sym.FullyConnected(x, num_hidden=2)
                x = pkg.sym.Activation(x, act_type="relu")
            x = x + x
            x = x * 3
        with pkg.name.Prefix("p_"):
            y = pkg.sym.FullyConnected(x, num_hidden=2)
        return y.tojson()

    assert names(tmx) == names(jmx)
