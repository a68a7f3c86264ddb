"""The port's layer API (ROADMAP A1) against the JAX package's.

Same numpy inputs and weights, made from a seed, go through both packages
on the CPU:

- every op the port registers beyond the LM's (unary, scalar and binary
  elementwise ops, conv2d, pool2d, flat, batch_norm, dropout,
  batch_matmul, the shape ops, the reductions, top_k), forward and
  gradients (`jax.vjp` against torch autograd, one random cotangent per
  float output), in float32 at rtol = atol = 2e-5 (sums in another
  order) and in bfloat16 at rtol = atol = 2e-2 (the frameworks round bf16
  at different points); gradients, and bf16 outputs, with the atol scaled
  by the largest entry of the JAX value, since they sum over many terms;
- dropout by what does not depend on the mask (no torch generator gives
  `jax.random`'s bits): rate 0 and eval mode exact, kept entries x/keep
  exactly, the kept share within five binomial standard deviations;
- ties: `top_k` indices and the max/min reductions' gradient split;
- the model builds of lm-smoke, the MLP zoo, ResNet-50 and ResNeXt-50:
  the same layer names, operators, shapes and weight specs;
- one train step of `build_mlp_unify` and of ResNet-50 (224 x 224, the
  zoo's size: its final 7 x 7 average pool needs a feature map of at
  least 7, so an input of at least 193) from the same weights: the loss
  and every gradient; tied weights, constants, `batch_matmul` under
  `seq_length`, and BatchNorm state carried by `load_params`.

The tensor-op policy (bf16 matmul inputs under fp32) applies on the
accelerator only, so it is off on both sides here.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import fftype as jft
from flexflow_tpu import ops as jops
from flexflow_tpu.fftype import OperatorType as JOT, PoolType as JPool
from flexflow_tpu.ops.base import OpContext as JCtx, get_op_def as jdef
from flexflow_tpu_torch import fftype as tft
from flexflow_tpu_torch import ops as tops
from flexflow_tpu_torch.fftype import OperatorType as TOT, PoolType as TPool
from flexflow_tpu_torch.ops.base import OpContext as TCtx, get_op_def as tdef

F32_TOL = dict(rtol=2e-5, atol=2e-5)
DTYPES = {
    "f32": (torch.float32, jnp.float32, F32_TOL),
    "bf16": (torch.bfloat16, jnp.bfloat16, dict(rtol=2e-2, atol=2e-2)),
}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "f" or str(
        x.dtype) == "bfloat16" else x


def _close(got, want, tol, scaled, msg=""):
    bound = dict(tol)
    if scaled:
        bound["atol"] = tol["atol"] * max(1.0, float(np.abs(_np(want)).max()))
    np.testing.assert_allclose(_np(got), _np(want), **bound, err_msg=msg)


def _is_float(a) -> bool:
    return np.asarray(a).dtype.kind == "f"


def _parity(op, jp, tp, inputs, weights, dtype, diff=(), *, training=False,
            state=None, seq_length=-1, zero_grad=False):
    """Forward `op` in both packages on the same inputs and weights (and
    state, kept float32 as the executors keep it), pull one random
    cotangent per float output back through each, and hold the outputs,
    the new state and the gradients of the `diff` inputs and of every
    weight to each other. `zero_grad`: the op's gradient is 0 in exact
    arithmetic (ceil, round): both must be exactly 0."""
    tdt, jdt, tol = DTYPES[dtype]
    state = state or {}
    names = sorted(weights)

    def jconv(a):
        return jnp.asarray(a, jdt) if _is_float(a) else jnp.asarray(a)

    def tconv(a):
        t = torch.tensor(a)
        return t.to(tdt) if _is_float(a) else t

    def jctx():
        return JCtx(training=training, seq_length=seq_length,
                    rng=jax.random.key(0) if training else None)

    def jf(dv, ws):
        ins = [jconv(a) for a in inputs]
        for i, t in zip(diff, dv):
            ins[i] = t
        w = dict(zip(names, ws))
        w.update({k: jnp.asarray(v) for k, v in state.items()})
        outs, st = jdef(getattr(JOT, op)).forward(jp, ins, w, None, jctx())
        fl = tuple(o for o in outs if jnp.issubdtype(o.dtype, jnp.floating))
        return fl, (outs, st or {})

    jdiff = [jconv(inputs[i]) for i in diff]
    jws = [jconv(weights[n]) for n in names]
    (jfl, (jouts, jst)) = jf(jdiff, jws)
    rs = np.random.RandomState(7)
    cots = [rs.randn(*o.shape).astype(np.float32) for o in jfl]
    grads_wanted = bool(jfl) and (diff or names)
    if grads_wanted:
        _, vjp, _ = jax.vjp(jf, jdiff, jws, has_aux=True)
        jgd, jgw = vjp(tuple(jnp.asarray(c, o.dtype)
                             for c, o in zip(cots, jfl)))

    tins = [tconv(a) for a in inputs]
    for i in diff:
        tins[i].requires_grad_(True)
    tws = {n: tconv(weights[n]).requires_grad_(True) for n in names}
    tw = dict(tws)
    tw.update({k: torch.tensor(v) for k, v in state.items()})
    gen = torch.Generator().manual_seed(0) if training else None
    touts, tst = tdef(getattr(TOT, op)).forward(
        tp, tins, tw, None,
        TCtx(training=training, seq_length=seq_length, rng=gen))
    assert len(touts) == len(jouts)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        assert tuple(t.shape) == tuple(j.shape), (op, i)
        if jnp.issubdtype(j.dtype, jnp.floating):
            assert str(t.dtype) == f"torch.{j.dtype}", (op, t.dtype)
            _close(t, j, tol, dtype == "bf16", f"{op} out{i}")
        else:
            np.testing.assert_array_equal(_np(t), np.asarray(j),
                                          err_msg=f"{op} out{i}")
    assert sorted(tst or {}) == sorted(jst)
    for k in jst:
        assert tst[k].dtype == torch.float32
        _close(tst[k], jst[k], tol, dtype == "bf16", f"{op} state {k}")
    if not grads_wanted:
        return
    tfl = [o for o in touts if o.is_floating_point()]
    torch.autograd.backward(tfl, [torch.tensor(c).to(o.dtype)
                                  for c, o in zip(cots, tfl)])
    for i, want in zip(diff, jgd):
        got = tins[i].grad
        if zero_grad:
            assert got is None or not got.any()
            assert not np.any(_np(want))
            continue
        assert got.dtype == tins[i].dtype
        _close(got, want, tol, True, f"{op} d_in{i}")
    for n, want in zip(names, jgw):
        assert tws[n].grad.dtype == tws[n].dtype
        _close(tws[n].grad, want, tol, True, f"{op} d_{n}")


def _j(name, cls, *a, **k):
    return getattr(jops, cls)(*a, **k)


# ------------------------------------------------------------------ cases
# Each case: (op enum name, params class, params args, inputs, weights,
# diff input indices, extra _parity options). Params are built in both
# packages from the same arguments (enum-valued arguments by name).

def _rs(seed=0):
    return np.random.RandomState(seed)


def _x(*shape, seed=0, positive=False):
    a = _rs(seed).randn(*shape).astype(np.float32)
    return (np.abs(a) + 0.5).astype(np.float32) if positive else a


_UNARY = {
    "exp": ("OP_EXP", {}), "log": ("OP_LOG", {"positive": True}),
    "sin": ("OP_SIN", {}), "cos": ("OP_COS", {}), "relu": ("OP_RELU", {}),
    "identity": ("OP_IDENTITY", {}), "sigmoid": ("OP_SIGMOID", {}),
    "tanh": ("OP_TANH", {}), "elu": ("OP_ELU", {}),
    "rsqrt": ("OP_RSQRT", {"positive": True}),
    "sqrt": ("OP_SQRT", {"positive": True}),
    "leaky_relu": ("OP_LEAKYRELU", {}),
    "ceil": ("OP_CEIL", {"zero_grad": True}),
    "round": ("OP_ROUND", {"zero_grad": True}),
}
_SCALAR = {
    # constants that bf16 does not hold exactly (JAX's weak typing rounds
    # them to the input's dtype first)
    "scalar_multiply": ("OP_SCALAR_MULTIPLY", 1.7),
    "scalar_add": ("OP_SCALAR_ADD", -0.3),
    "scalar_sub": ("OP_SCALAR_SUB", 2.2),
    "scalar_true_divide": ("OP_SCALAR_TRUE_DIV", 0.7),
    "pow": ("OP_POW", 2.5),
}
_BINARY = ("OP_EW_ADD", "OP_EW_SUB", "OP_EW_MUL", "OP_EW_DIV", "OP_EW_MAX",
           "OP_EW_MIN")
_COMPARE = ("OP_EW_EQUAL", "OP_EW_GREATER", "OP_EW_LESS")


def _elementwise_case(name):
    if name in _UNARY:
        op, o = _UNARY[name]
        # round: values away from .5 (both round half to even; the bf16
        # cast could move a value onto a half)
        x = _x(3, 7, 5, positive=o.get("positive", False)) * 3
        if name == "round":
            x = np.floor(x) + 0.25
        return (op, "ElementUnaryParams", (op,), [x.astype(np.float32)],
                {}, [0], {"zero_grad": o.get("zero_grad", False)})
    if name in _SCALAR:
        op, c = _SCALAR[name]
        x = _x(3, 7, 5, positive=(name == "pow"))
        return (op, "ElementUnaryParams", (op, True, c), [x], {}, [0], {})
    if name == "scalar_floor_divide":
        x = _x(3, 7, 5) * 4
        return ("OP_SCALAR_FLOOR_DIV", "ElementUnaryParams",
                ("OP_SCALAR_FLOOR_DIV", True, 1.5), [x], {}, [], {})
    if name == "logical_not":
        b = _rs(1).rand(4, 6) > 0.5
        return ("OP_LOGICAL_NOT", "ElementUnaryParams", ("OP_LOGICAL_NOT",),
                [b], {}, [], {})
    if name in _BINARY:
        # (3, 1, 5) against (4, 5): NumPy broadcasting to (3, 4, 5)
        a, b = _x(3, 1, 5, seed=2), _x(4, 5, seed=3)
        if name == "OP_EW_DIV":
            b = np.abs(b) + 0.5
        return (name, "ElementBinaryParams", (name,), [a, b], {}, [0, 1], {})
    assert name in _COMPARE
    a, b = _x(3, 1, 5, seed=2), _x(4, 5, seed=3)
    b[0, :2] = a[0, 0, :2]  # some equal entries
    return (name, "ElementBinaryParams", (name,), [a, b], {}, [], {})


def _conv_case(name):
    rs = _rs(4)
    cfg = {
        # (in (n, c, h, w), (out, kh, kw, sh, sw, ph, pw, groups, bias, act))
        "s2_p1_bias_relu": ((2, 4, 9, 9),
                            (6, 3, 3, 2, 2, 1, 1, 1, True, "AC_MODE_RELU")),
        "groups2_nobias_sigmoid": ((2, 4, 8, 8),
                                   (6, 3, 3, 1, 1, 0, 0, 2, False,
                                    "AC_MODE_SIGMOID")),
        "rect_3x1_tanh": ((2, 3, 7, 6),
                          (5, 3, 1, 1, 2, 1, 0, 1, True, "AC_MODE_TANH")),
        "stem_7x7_s2_p3": ((2, 3, 16, 16),
                           (8, 7, 7, 2, 2, 3, 3, 1, True, "AC_MODE_NONE")),
    }
    shape, (oc, kh, kw, sh, sw, ph, pw, g, bias, act) = cfg[name]
    x = rs.randn(*shape).astype(np.float32)
    w = {"kernel": (rs.randn(oc, shape[1] // g, kh, kw)
                    / np.sqrt(shape[1] * kh * kw)).astype(np.float32)}
    if bias:
        w["bias"] = rs.randn(oc).astype(np.float32)
    args = (oc, kh, kw, sh, sw, ph, pw, g, bias, ("ActiMode", act))
    return ("OP_CONV2D", "Conv2DParams", args, [x], w, [0], {})


def _pool_case(name):
    cfg = {
        # (kh, kw, sh, sw, ph, pw, type, activation)
        "max_k3_s2_p1": (3, 3, 2, 2, 1, 1, "POOL_MAX", "AC_MODE_NONE"),
        "avg_k3_s2_p1": (3, 3, 2, 2, 1, 1, "POOL_AVG", "AC_MODE_NONE"),
        # padding above kernel // 2: explicit -inf / 0 padding in the port
        "max_k3_s1_p2": (3, 3, 1, 1, 2, 2, "POOL_MAX", "AC_MODE_NONE"),
        "avg_k3_s1_p2_relu": (3, 3, 1, 1, 2, 2, "POOL_AVG", "AC_MODE_RELU"),
        "avg_k7_s1_p0": (7, 7, 1, 1, 0, 0, "POOL_AVG", "AC_MODE_NONE"),
    }
    kh, kw, sh, sw, ph, pw, pt, act = cfg[name]
    x = _x(2, 3, 9, 9, seed=5)
    args = (kh, kw, sh, sw, ph, pw, ("PoolType", pt), ("ActiMode", act))
    return ("OP_POOL2D", "Pool2DParams", args, [x], {}, [0], {})


def _bn_case(name):
    rs = _rs(6)
    x = (rs.randn(3, 4, 5, 5) * 2 + 1).astype(np.float32)
    w = {"scale": rs.randn(4).astype(np.float32),
         "bias": rs.randn(4).astype(np.float32)}
    st = {"running_mean": rs.randn(4).astype(np.float32),
          "running_var": (rs.rand(4) + 0.5).astype(np.float32)}
    training = name.startswith("train")
    relu = name.endswith("relu")
    return ("OP_BATCHNORM", "BatchNormParams", (relu,), [x], w, [0],
            {"training": training, "state": st})


def _shape_case(name):
    x = _x(2, 3, 4, 5, seed=8)
    if name == "flat":
        return ("OP_FLAT", None, None, [x], {}, [0], {})
    if name == "concat":
        ys = [_x(2, n, 4, 5, seed=9 + n) for n in (3, 1, 2)]
        return ("OP_CONCAT", "ConcatParams", (1, 3), ys, {}, [0, 1, 2], {})
    if name == "split":
        return ("OP_SPLIT", "SplitParams", ((2, 1, 2), -1), [x], {}, [0], {})
    if name == "reshape":
        return ("OP_RESHAPE", "ReshapeParams", ((6, 20),), [x], {}, [0], {})
    if name == "transpose":
        return ("OP_TRANSPOSE", "TransposeParams", ((2, 0, 3, 1),), [x], {},
                [0], {})
    if name == "reverse":
        return ("OP_REVERSE", "ReverseParams", (1,), [x], {}, [0], {})
    if name == "cast_int32":
        return ("OP_CAST", "CastParams", (("DataType", "DT_INT32"),),
                [x * 3], {}, [], {})
    if name == "cast_bf16":
        return ("OP_CAST", "CastParams", (("DataType", "DT_BFLOAT16"),), [x],
                {}, [0], {})
    if name == "gather":
        idx = _rs(10).randint(0, 5, (2, 3, 4, 2)).astype(np.int32)
        idx[0, 0, 0, :] = 1  # a repeated index: its gradients add up
        return ("OP_GATHER", "GatherParams", (3,), [x, idx], {}, [0], {})
    if name == "top_k":
        return ("OP_TOPK", "TopKParams", (3,), [x], {}, [0], {})
    red = {"reduce_sum": ("OP_REDUCE_SUM", (0, 2), False),
           "reduce_mean": ("OP_REDUCE_MEAN", (1,), True),
           "mean": ("OP_MEAN", (-1, 1), False),
           "reduce_max": ("OP_REDUCE_MAX", (1, 3), False),
           "reduce_min": ("OP_REDUCE_MIN", (2,), True),
           "reduce_prod": ("OP_REDUCE_PROD", (-1, 0), False)}
    op, axes, keep = red[name]
    xin = (_x(2, 3, 4, 5, seed=8, positive=True) * 0.8
           if op == "OP_REDUCE_PROD" else x)
    return (op, "ReduceParams", (op, axes, keep), [xin], {}, [0], {})


def _misc_case(name):
    if name.startswith("bmm"):
        a, b = _x(2, 5, 3, seed=11), _x(2, 3, 4, seed=12)
        if name == "bmm":
            return ("OP_BATCHMATMUL", "BatchMatmulParams", (), [a, b], {},
                    [0, 1], {})
        # seq_length 3 truncates A's dim 1 (FFIterationConfig::seq_length)
        return ("OP_BATCHMATMUL", "BatchMatmulParams", (1, -1), [a, b], {},
                [0, 1], {"seq_length": 3})
    x = _x(4, 6, 5, seed=13)
    if name == "dropout_rate0_training":
        return ("OP_DROPOUT", "DropoutParams", (0.0,), [x], {}, [0],
                {"training": True})
    assert name == "dropout_eval"
    return ("OP_DROPOUT", "DropoutParams", (0.5,), [x], {}, [0], {})


CASES = {}
for _n in (list(_UNARY) + list(_SCALAR) + ["scalar_floor_divide",
                                           "logical_not"]
           + list(_BINARY) + list(_COMPARE)):
    CASES[f"ew_{_n}"] = (_elementwise_case, _n)
for _n in ("s2_p1_bias_relu", "groups2_nobias_sigmoid", "rect_3x1_tanh",
           "stem_7x7_s2_p3"):
    CASES[f"conv2d_{_n}"] = (_conv_case, _n)
for _n in ("max_k3_s2_p1", "avg_k3_s2_p1", "max_k3_s1_p2",
           "avg_k3_s1_p2_relu", "avg_k7_s1_p0"):
    CASES[f"pool2d_{_n}"] = (_pool_case, _n)
for _n in ("train", "train_relu", "eval", "eval_relu"):
    CASES[f"batch_norm_{_n}"] = (_bn_case, _n)
for _n in ("flat", "concat", "split", "reshape", "transpose", "reverse",
           "cast_int32", "cast_bf16", "gather", "top_k", "reduce_sum",
           "reduce_mean", "mean", "reduce_max", "reduce_min", "reduce_prod"):
    CASES[_n] = (_shape_case, _n)
for _n in ("bmm", "bmm_seq_length", "dropout_rate0_training",
           "dropout_eval"):
    CASES[_n] = (_misc_case, _n)


def _params(pkg, ft, cls, args):
    """Params of `cls` in package `pkg` from `args`: an enum-typed
    argument is (enum class name, member name), an op name string
    becomes the package's OperatorType."""
    if cls is None:
        return None
    conv = []
    for a in args:
        if isinstance(a, tuple) and len(a) == 2 and isinstance(a[0], str) \
                and hasattr(ft, a[0]):
            conv.append(getattr(getattr(ft, a[0]), a[1]))
        elif isinstance(a, str) and a.startswith("OP_"):
            conv.append(getattr(ft.OperatorType, a))
        else:
            conv.append(a)
    return getattr(pkg, cls)(*conv)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case, dtype):
    make, arg = CASES[case]
    op, cls, args, inputs, weights, diff, opts = make(arg)
    _parity(op, _params(jops, jft, cls, args), _params(tops, tft, cls, args),
            inputs, weights, dtype, diff, **opts)


# ------------------------------------------------------------------ enums


def test_every_registered_op_has_the_jax_enum_value():
    from flexflow_tpu_torch.ops import registered_ops

    ops = registered_ops()
    assert len(ops) == len(TOT) - 1  # all but OP_INPUT
    for ot in TOT:
        assert int(getattr(JOT, ot.name)) == int(ot), ot.name
    for a, b in ((tft.PoolType, jft.PoolType),
                 (tft.RegularizerMode, jft.RegularizerMode),
                 (tft.ParameterSyncType, jft.ParameterSyncType)):
        assert {m.name: int(m) for m in a} == {m.name: int(m) for m in b}
    for dt in tft.DataType:
        if dt == tft.DataType.DT_NONE:
            continue
        assert tft.size_of_datatype(dt) == jft.size_of_datatype(
            getattr(jft.DataType, dt.name)), dt.name
        assert tft.torch_to_dtype(tft.dtype_to_torch(dt)) == dt


def test_op_flops_are_the_jax_packages():
    cases = [
        ("OP_CONV2D", "Conv2DParams", (6, 3, 3, 2, 2, 1, 1, 2),
         [(2, 4, 9, 9)]),
        ("OP_LINEAR", "LinearParams", (48,), [(4, 8, 128)]),
        ("OP_BATCHMATMUL", "BatchMatmulParams", (), [(2, 5, 3), (2, 3, 4)]),
        ("OP_MULTIHEAD_ATTENTION", "MultiHeadAttentionParams", (64, 4),
         [(2, 16, 64)] * 3),
        ("OP_POOL2D", "Pool2DParams", (3, 3, 2, 2, 1, 1), [(2, 3, 9, 9)]),
        ("OP_RELU", "ElementUnaryParams", ("OP_RELU",), [(3, 7)]),
    ]
    for op, cls, args, shapes in cases:
        jp, tp = _params(jops, jft, cls, args), _params(tops, tft, cls, args)
        jd, td = jdef(getattr(JOT, op)), tdef(getattr(TOT, op))
        outs = td.infer_shapes(tp, shapes)
        assert [tuple(o) for o in jd.infer_shapes(jp, shapes)] == [
            tuple(o) for o in outs]
        assert td.flops(tp, shapes, outs) == jd.flops(jp, shapes, outs), op


def test_machine_is_the_jax_packages_without_the_mesh():
    from flexflow_tpu import machine as jm
    from flexflow_tpu_torch import machine as tm

    v = tm.MachineView(2, (2, 3), (3, 1), 4)
    jv = jm.MachineView(2, (2, 3), (3, 1), 4)
    assert v.device_ids() == jv.device_ids() and v.hash() == jv.hash()
    assert v.num_parts == jv.num_parts == 6
    assert tm.MachineResource(2, 8, 4).num_devices == 8
    for sizes in ({}, {"data": 4}, {"dcn": 2}, {"dcn": 2, "data": 2}):
        assert tm.batch_axes_for(sizes) == jm.batch_axes_for(sizes)
    assert tm.DEFAULT_AXES == jm.DEFAULT_AXES
    assert tm.MULTIHOST_AXES == jm.MULTIHOST_AXES
    assert tm.MeshShape.data_parallel(8).num_devices == 8
    with pytest.raises(ValueError):
        tm.MeshShape((2, 2), ("data",))
    # the mesh: one device needs no process group; more raise without one
    mesh = tm.build_mesh(tm.MeshShape((1, 1, 1, 1)))
    assert dict(mesh.shape) == {"data": 1, "model": 1, "pipe": 1, "seq": 1}
    assert mesh.size == 1 and mesh.group(("data",)) is None
    assert tm.spec_num_shards(mesh, ("data", None)) == 1
    with pytest.raises(ValueError, match="mesh needs 2 devices"):
        tm.build_mesh(tm.MeshShape((2, 1, 1, 1)))


# ------------------------------------------------------------------ ties


def test_top_k_breaks_ties_by_the_lower_index():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0],
                  [5.0, 5.0, 5.0, 5.0, 5.0, 5.0],
                  [0.0, -1.0, 0.0, 2.0, 2.0, -1.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    (tv, ti), _ = tdef(TOT.OP_TOPK).forward(tops.TopKParams(4), [
        torch.tensor(x)], {}, None, TCtx())
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.dtype == torch.int32


@pytest.mark.parametrize("op", ["OP_REDUCE_MAX", "OP_REDUCE_MIN"])
def test_max_min_reductions_split_the_gradient_between_ties(op):
    x = np.array([[[1.0, 4.0, 4.0], [2.0, 2.0, -3.0]],
                  [[0.5, 0.5, 0.5], [-1.0, -3.0, -3.0]]], np.float32)
    _parity(op, jops.ReduceParams(getattr(JOT, op), (2,)),
            tops.ReduceParams(getattr(TOT, op), (2,)), [x], {}, "f32", [0])
    # the split itself: 1/2 to each of two ties, 1/3 to each of three
    tx = torch.tensor(x, requires_grad=True)
    (y,), _ = tdef(getattr(TOT, op)).forward(
        tops.ReduceParams(getattr(TOT, op), (2,)), [tx], {}, None, TCtx())
    y.sum().backward()
    g = tx.grad.numpy()
    assert np.isclose(g[1, 0], 1.0 / 3.0).all()
    assert sorted(np.round(g[0, 0], 6)) in ([0.0, 0.5, 0.5], [0.0, 0.0, 1.0])


# ------------------------------------------------------------------ dropout


def _dropout(x, rate, gen, training=True):
    (y,), _ = tdef(TOT.OP_DROPOUT).forward(
        tops.DropoutParams(rate), [x], {}, None,
        TCtx(training=training, rng=gen))
    return y


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dropout_kept_entries_and_share(dtype):
    """Kept entries are x / keep exactly, the rest 0; the kept share of
    4096 entries lies within five binomial standard deviations of keep —
    in both packages. The division is JAX's weak-typed one: keep rounded
    to the activation dtype first (bf16 0.7 is 0.69921875)."""
    tdt, jdt, _ = DTYPES[dtype]
    x = (_x(64, 64, seed=14, positive=True)).astype(np.float32)
    rate, keep, n = 0.3, 0.7, x.size
    sd = np.sqrt(n * keep * (1 - keep))
    y = _dropout(torch.tensor(x).to(tdt), rate,
                 torch.Generator().manual_seed(3))
    (jy,), _ = jdef(JOT.OP_DROPOUT).forward(
        jops.DropoutParams(rate), [jnp.asarray(x, jdt)], {}, None,
        JCtx(training=True, rng=jax.random.key(3)))
    for got, xin in ((y, torch.tensor(x).to(tdt)),
                     (torch.tensor(_np(jy)).to(tdt), torch.tensor(x).to(tdt))):
        assert got.dtype == tdt
        kept = got != 0
        assert abs(int(kept.sum()) - n * keep) <= 5 * sd
        want = xin / torch.tensor(keep, dtype=tdt)
        assert torch.equal(got[kept], want[kept])


def test_dropout_draws_from_the_generator():
    """The same generator state gives the same mask; each draw advances
    the generator, so the next mask differs."""
    x = torch.ones(32, 32)
    a = _dropout(x, 0.5, torch.Generator().manual_seed(9))
    b = _dropout(x, 0.5, torch.Generator().manual_seed(9))
    assert torch.equal(a, b)
    g = torch.Generator().manual_seed(9)
    first, second = _dropout(x, 0.5, g), _dropout(x, 0.5, g)
    assert torch.equal(first, a) and not torch.equal(first, second)
    with pytest.raises(ValueError, match="generator"):
        _dropout(x, 0.5, None)


# ------------------------------------------------------------------ models


def _jax_ff(batch=2, argv=()):
    sys.argv = ["test"] + list(argv)
    from flexflow_tpu import FFConfig, FFModel

    cfg = FFConfig()
    cfg.mesh_axis_sizes = (1, 1, 1, 1)
    cfg.batch_size = batch
    return FFModel(cfg)


def _torch_ff(batch=2, argv=()):
    sys.argv = ["test"] + list(argv)
    from flexflow_tpu_torch import FFConfig, FFModel

    cfg = FFConfig(device="cpu")
    cfg.batch_size = batch
    return FFModel(cfg)


def _build(which, ff, pkg):
    models = __import__(f"{pkg}.models", fromlist=["x"])
    if which == "lm-smoke":
        if pkg == "flexflow_tpu":
            from flexflow_tpu.models.transformer import TRANSFORMER_LM_ZOO
        else:
            from flexflow_tpu_torch.models import TRANSFORMER_LM_ZOO
        models.build_transformer_lm(ff, TRANSFORMER_LM_ZOO["lm-smoke"],
                                    batch_size=2)
    elif which == "mnist_mlp":
        models.build_mnist_mlp(ff, batch_size=2)
    elif which == "mlp_unify":
        models.build_mlp_unify(ff, batch_size=2)
    elif which == "resnet50":
        models.build_resnet50(ff, batch_size=2)
    else:
        models.build_resnext50(ff, batch_size=2)


def _layer_table(ff, get_def):
    rows = []
    for t in ff._input_tensors:
        rows.append(("input", t.name, t.dims, int(t.dtype)))
    for l in ff.layers:
        specs = get_def(l.op_type).weights(l.params,
                                           [t.dims for t in l.inputs])
        rows.append((l.name, l.op_type.name,
                     [t.dims for t in l.inputs],
                     [t.dims for t in l.outputs],
                     [(w.name, tuple(w.shape), int(w.dtype), w.initializer,
                       w.trainable) for w in specs]))
    return rows


@pytest.mark.parametrize("which", ["lm-smoke", "mnist_mlp", "mlp_unify",
                                   "resnet50", "resnext50"])
def test_model_builds_agree(which):
    """A1's acceptance: the same layer names, operators, input and output
    shapes and weight specs (name, shape, dtype, initializer, trainable)
    in both packages."""
    jff, tff = _jax_ff(), _torch_ff()
    _build(which, jff, "flexflow_tpu")
    _build(which, tff, "flexflow_tpu_torch")
    jt, tt = _layer_table(jff, jdef), _layer_table(tff, tdef)
    assert len(jt) == len(tt)
    for j, t in zip(jt, tt):
        assert j == t


def _copy(jff, tff, with_state=False):
    from flexflow_tpu_torch import load_params

    params = {n: {w: np.asarray(v) for w, v in ws.items()}
              for n, ws in jff._params.items()}
    assert set(params) == set(tff._params)
    if with_state:
        for n, ws in (jff._state or {}).items():
            params.setdefault(n, {}).update(
                {w: np.asarray(v) for w, v in ws.items()})
    return load_params(tff, params)


def _grads_close(jgrads, tgrads, rtol, what):
    """Every gradient within `rtol` of its layer's largest gradient
    entry (summation order differs through the network)."""
    assert set(jgrads) == set(tgrads)
    for n, ws in jgrads.items():
        scale = max(float(np.abs(np.asarray(v)).max()) for v in ws.values())
        for w, v in ws.items():
            np.testing.assert_allclose(
                _np(tgrads[n][w]), np.asarray(v), rtol=rtol,
                atol=rtol * max(scale, 1e-30), err_msg=f"{what} {n}.{w}")


def _step_both(jff, tff, x, y):
    """One loss-and-gradient evaluation (the granular `backward`) of both
    models on the same batch; returns (jax loss, port loss)."""
    jff.start_batch(x, y)
    tff.start_batch(x, y)
    return float(jff.backward()), float(tff.backward())


def test_mlp_unify_train_step_matches_jax():
    from flexflow_tpu import LossType as JL, SGDOptimizer as JSGD
    from flexflow_tpu.models import build_mlp_unify as jbuild
    from flexflow_tpu_torch import LossType as TL, SGDOptimizer as TSGD
    from flexflow_tpu_torch.models import build_mlp_unify as tbuild

    jff, tff = _jax_ff(4), _torch_ff(4)
    jbuild(jff, batch_size=4, in_dim=24, hidden_dims=(64, 32, 10))
    tbuild(tff, batch_size=4, in_dim=24, hidden_dims=(64, 32, 10))
    jff.compile(optimizer=JSGD(lr=0.05),
                loss_type=JL.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    tff.compile(optimizer=TSGD(lr=0.05),
                loss_type=TL.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    _copy(jff, tff)
    rs = _rs(15)
    x = {"input1": rs.randn(4, 24).astype(np.float32),
         "input2": rs.randn(4, 24).astype(np.float32)}
    y = rs.randint(0, 10, (4, 1)).astype(np.int32)
    jl, tl = _step_both(jff, tff, x, y)
    np.testing.assert_allclose(tl, jl, **F32_TOL)
    _grads_close(jff._grads, tff._grads, 2e-5, "mlp_unify")
    jff.update()
    tff.update()
    for n, ws in jff._params.items():
        for w, v in ws.items():
            np.testing.assert_allclose(tff.get_weight(n, w), np.asarray(v),
                                       **F32_TOL)


def test_resnet50_train_step_matches_jax():
    """ResNet-50 at the zoo's 224 x 224, batch 2, float32, from the same
    weights: the loss (rtol 1e-4) and every gradient of one step (53
    convolutions summed in another order by XLA and by torch)."""
    from flexflow_tpu import LossType as JL, SGDOptimizer as JSGD
    from flexflow_tpu.models import build_resnet50 as jbuild
    from flexflow_tpu_torch import LossType as TL, SGDOptimizer as TSGD
    from flexflow_tpu_torch.models import build_resnet50 as tbuild

    jff, tff = _jax_ff(2), _torch_ff(2)
    jbuild(jff, batch_size=2)
    tbuild(tff, batch_size=2)
    jff.compile(optimizer=JSGD(lr=0.01),
                loss_type=JL.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    tff.compile(optimizer=TSGD(lr=0.01),
                loss_type=TL.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    _copy(jff, tff)
    rs = _rs(16)
    x = rs.randn(2, 3, 224, 224).astype(np.float32)
    y = rs.randint(0, 10, (2, 1)).astype(np.int32)
    jl, tl = _step_both(jff, tff, x, y)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    # an entry whose pre-activation sits at a ReLU's kink may take the
    # other side in the other package: each gradient is held to 1e-2 of
    # its layer's largest entry per element, and to 1e-3 in norm
    _grads_close(jff._grads, tff._grads, 1e-2, "resnet50")
    for n, ws in jff._grads.items():
        for w, v in ws.items():
            want = np.asarray(v)
            err = np.linalg.norm(_np(tff._grads[n][w]) - want)
            assert err <= 1e-3 * max(np.linalg.norm(want), 1e-30), (n, w)


def _conv_bn_model(ff, pkg, dropout=0.0):
    """conv -> batch_norm -> dropout -> pool -> dense -> softmax."""
    ft = __import__(f"{pkg}.fftype", fromlist=["x"])
    x = ff.create_tensor((4, 3, 8, 8), name="input")
    t = ff.conv2d(x, 6, 3, 3, 1, 1, 1, 1, name="conv")
    t = ff.batch_norm(t, name="bn")
    t = ff.dropout(t, dropout, name="drop")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, ft.PoolType.POOL_MAX, name="pool")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, 5, name="fc")
    return ff.softmax(t, name="softmax")


def _compile_pair(jff, tff, **kw):
    from flexflow_tpu import LossType as JL, SGDOptimizer as JSGD
    from flexflow_tpu_torch import LossType as TL, SGDOptimizer as TSGD

    jff.compile(optimizer=JSGD(lr=0.1),
                loss_type=JL.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, **kw)
    tff.compile(optimizer=TSGD(lr=0.1),
                loss_type=TL.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY, **kw)


def test_batch_norm_model_fit_matches_jax_running_stats_included():
    """Two fit steps of conv -> BN -> pool -> dense in both packages from
    the same weights: the masters and BatchNorm's running statistics
    (non-trainable state, written back in place) agree."""
    jff, tff = _jax_ff(4), _torch_ff(4)
    _conv_bn_model(jff, "flexflow_tpu")
    _conv_bn_model(tff, "flexflow_tpu_torch")
    _compile_pair(jff, tff)
    _copy(jff, tff, with_state=True)
    held = tff._state["bn"]["running_mean"]
    rs = _rs(17)
    x = rs.randn(8, 3, 8, 8).astype(np.float32)
    y = rs.randint(0, 5, (8, 1)).astype(np.int32)
    jff.fit(x, y, epochs=1, batch_size=4, shuffle=False, verbose=False)
    tff.fit(x, y, epochs=1, batch_size=4, shuffle=False, verbose=False)
    assert tff._state["bn"]["running_mean"] is held
    for tree_j, tree_t in ((jff._params, tff._params),
                           (jff._state, tff._state)):
        for n, ws in tree_j.items():
            for w, v in ws.items():
                np.testing.assert_allclose(_np(tree_t[n][w]), np.asarray(v),
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=f"{n}.{w}")


def test_load_params_carries_batch_norm_state():
    """`load_params` sets non-trainable state by name, in place, with the
    name and shape checks of the parameters: the JAX model's running
    statistics (moved by two training steps) give the same eval-mode
    outputs in the port."""
    from flexflow_tpu_torch import CompMode as TCM
    from flexflow_tpu.fftype import CompMode as JCM

    jff, tff = _jax_ff(4), _torch_ff(4)
    _conv_bn_model(jff, "flexflow_tpu")
    _conv_bn_model(tff, "flexflow_tpu_torch")
    _compile_pair(jff, tff)
    rs = _rs(18)
    x = rs.randn(8, 3, 8, 8).astype(np.float32)
    y = rs.randint(0, 5, (8, 1)).astype(np.int32)
    jff.fit(x, y, epochs=1, batch_size=4, verbose=False)
    rm = np.asarray(jff._state["bn"]["running_mean"])
    assert np.abs(rm).max() > 0  # the statistics moved
    held = tff._state["bn"]["running_var"]
    n = _copy(jff, tff, with_state=True)
    assert n == sum(len(w) for w in jff._params.values()) + 2
    assert tff._state["bn"]["running_var"] is held
    np.testing.assert_array_equal(_np(held),
                                  np.asarray(jff._state["bn"]["running_var"]))
    jff.config.computation_mode = JCM.COMP_MODE_INFERENCE
    tff.config.computation_mode = TCM.COMP_MODE_INFERENCE
    jff.start_batch(x[:4], y[:4])
    tff.start_batch(x[:4], y[:4])
    np.testing.assert_allclose(_np(tff.forward()), np.asarray(jff.forward()),
                               **F32_TOL)
    from flexflow_tpu_torch import load_params

    with pytest.raises(ValueError, match="shape"):
        load_params(tff, {"bn": {"running_mean": np.zeros(3, np.float32)}})
    with pytest.raises(KeyError):
        load_params(tff, {"bn": {"running_stddev": rm}})


def test_dropout_model_trains_and_eval_is_exact():
    """A model with dropout 0.5 trains under the port (the model's
    generator, advanced per step); at eval dropout is the identity, as in
    JAX: eval-mode logits agree from the same weights."""
    from flexflow_tpu import MetricsType as JM
    from flexflow_tpu_torch import MetricsType as TM

    jff, tff = _jax_ff(4), _torch_ff(4)
    _conv_bn_model(jff, "flexflow_tpu", dropout=0.5)
    _conv_bn_model(tff, "flexflow_tpu_torch", dropout=0.5)
    _compile_pair(jff, tff)
    _copy(jff, tff, with_state=True)
    rs = _rs(19)
    x = rs.randn(8, 3, 8, 8).astype(np.float32)
    y = rs.randint(0, 5, (8, 1)).astype(np.int32)
    jm = jff.eval(x, y)
    tm = tff.eval(x, y)
    assert jm.get_accuracy() == tm.get_accuracy()
    offset = tff._rng.get_state().clone()
    tff.fit(x, y, epochs=1, batch_size=4, verbose=False)
    assert not torch.equal(offset, tff._rng.get_state())
    assert all(np.isfinite(tff.get_weight("fc", "kernel")).ravel())
    del JM, TM


def test_constant_input_is_made_by_the_executor():
    """`create_constant`: fit and forward take no array for it; the JAX
    training path has no materialisation for it (its executor reads every
    input from the batch, ROADMAP queue C, reference-side), so the JAX
    side is given the constant's array by name."""
    jff, tff = _jax_ff(4), _torch_ff(4)
    for ff in (jff, tff):
        x = ff.create_tensor((4, 8), name="input")
        c = ff.create_constant((4, 8), 0.75, x.dtype)
        t = ff.multiply(ff.add(x, c, name="add"), c, name="mul")
        t = ff.dense(t, 3, name="fc")
    _compile_pair(jff, tff)
    _copy(jff, tff)
    rs = _rs(20)
    x = rs.randn(4, 8).astype(np.float32)
    y = rs.randint(0, 3, (4, 1)).astype(np.int32)
    cname = jff._input_tensors[1].name
    assert cname == tff._input_tensors[1].name == "const_1"
    jff.start_batch({"input": x, cname: np.full((4, 8), 0.75, np.float32)},
                    y)
    tff.start_batch(x, y)
    np.testing.assert_allclose(_np(tff.forward()), np.asarray(jff.forward()),
                               **F32_TOL)
    tff.fit(np.concatenate([x, x]), np.concatenate([y, y]), epochs=1,
            batch_size=4, verbose=False)
    assert np.isfinite(tff.get_weight("fc", "kernel")).all()


def test_tied_dense_one_param_set_summed_grads_as_jax():
    """`dense(..., shared_op=)` (tests/test_weight_sharing.py's spec): one
    parameter set under the source's name, readable under both names,
    and its gradient the sum over both uses — equal to the JAX model's."""
    from flexflow_tpu import LossType as JL, SGDOptimizer as JSGD
    from flexflow_tpu_torch import LossType as TL, SGDOptimizer as TSGD

    jff, tff = _jax_ff(4), _torch_ff(4)
    for ff in (jff, tff):
        x = ff.create_tensor((4, 8), name="x")
        t1 = ff.dense(x, 8, use_bias=False, name="w")
        ff.dense(t1, 8, use_bias=False, name="w2", shared_op=t1)
    jff.compile(optimizer=JSGD(lr=0.1),
                loss_type=JL.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    tff.compile(optimizer=TSGD(lr=0.1),
                loss_type=TL.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    assert "w" in tff._params and "w2" not in tff._params
    _copy(jff, tff)
    assert np.array_equal(tff.get_weight("w2", "kernel"),
                          tff.get_weight("w", "kernel"))
    rs = _rs(21)
    xs = rs.randn(4, 8).astype(np.float32)
    ys = rs.randn(4, 8).astype(np.float32)
    jl, tl = _step_both(jff, tff, xs, ys)
    np.testing.assert_allclose(tl, jl, **F32_TOL)
    _grads_close(jff._grads, tff._grads, 2e-5, "tied")
    jff.fit(xs, ys, epochs=3, shuffle=False, verbose=False)
    tff.fit(xs, ys, epochs=3, shuffle=False, verbose=False)
    np.testing.assert_allclose(tff.get_weight("w2", "kernel"),
                               jff.get_weight("w2", "kernel"),
                               rtol=2e-4, atol=2e-5)


def test_tied_embedding_and_bad_ties():
    from flexflow_tpu_torch.fftype import DataType

    tff = _torch_ff(8)
    toks = tff.create_tensor((8, 4), DataType.DT_INT32, name="toks")
    e1 = tff.embedding(toks, 32, 16, name="emb")
    toks2 = tff.create_tensor((8, 4), DataType.DT_INT32, name="toks2")
    e2 = tff.embedding(toks2, 32, 16, name="emb2", shared_op=e1)
    t = tff.relu(tff.add(e1, e2), name="r")
    with pytest.raises(ValueError, match="shared_op"):
        tff.dense(t, 8, shared_op=t)  # t is the relu output
    with pytest.raises(TypeError, match="shared_op"):
        tff.dense(t, 8, shared_op=3)
    t = tff.dense(t, 8, name="head")
    tff.compile()
    assert "emb2" not in tff._params
    assert np.array_equal(tff.get_weight("emb2", "kernel"),
                          tff.get_weight("emb", "kernel"))
    bad = _torch_ff(8)
    x = bad.create_tensor((8, 4))
    a = bad.dense(x, 4, name="a")
    bad.dense(a, 6, name="b", shared_op=a)
    with pytest.raises(ValueError, match="shape"):
        bad.compile()


def test_batch_matmul_under_seq_length_reaches_the_op():
    """`forward(seq_length)` and `backward(seq_length)` reach the ops'
    context: batch_matmul truncates the dims it names, as the JAX op does
    under the same context (the JAX model's forward drops the argument:
    ROADMAP queue C, reference-side)."""
    from flexflow_tpu_torch import LossType

    rs = _rs(22)
    a, b = _x(2, 6, 4, seed=23), _x(2, 4, 3, seed=24)
    (want,), _ = jdef(JOT.OP_BATCHMATMUL).forward(
        jops.BatchMatmulParams(1, -1), [jnp.asarray(a), jnp.asarray(b)], {},
        None, JCtx(seq_length=3))
    tff = _torch_ff(2)
    ta = tff.create_tensor((2, 6, 4), name="a")
    tb = tff.create_tensor((2, 4, 3), name="b")
    tff.batch_matmul(ta, tb, a_seq_length_dim=1, name="bmm")
    tff.compile(loss_type=LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    tff.start_batch({"a": a, "b": b}, rs.randn(2, 3, 3).astype(np.float32))
    got = tff.forward(seq_length=3)
    assert tuple(got.shape) == (2, 3, 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    assert tuple(tff.forward().shape) == (2, 6, 3)
    assert np.isfinite(float(tff.backward(seq_length=3)))


def test_export_dot_and_print_layers(capsys):
    jff, tff = _jax_ff(), _torch_ff()
    for ff in (jff, tff):
        _conv_bn_model(ff, type(ff).__module__.split(".")[0])
    _compile_pair(jff, tff)
    jd, td = jff.export_dot(), tff.export_dot()
    for dot in (jd, td):
        assert dot.startswith("digraph PCG {") and dot.endswith("}")
    assert td.count("->") == jd.count("->")
    for l in tff.layers:
        assert f'"{l.name}\\n{l.op_type.name}' in td
    tff.print_layers()
    out = capsys.readouterr().out.splitlines()
    jff.print_layers()
    assert capsys.readouterr().out.splitlines() == out


@pytest.mark.parametrize("method", [
    "enable_checkpointing", "save_checkpoint",
    "load_checkpoint", "set_fault_hook", "enable_diagnostics",
    "get_diagnostics", "enable_elastic", "profile_step", "moe", "experts",
    "group_by", "aggregate", "aggregate_spec", "cache"])
def test_unported_model_methods_raise_naming_their_item(method):
    """Every public FFModel method of the JAX package is in the port or
    raises, naming its ROADMAP item; other missing names stay
    AttributeErrors. The resilience methods listed here are ported
    (A10's training half): they are methods of the port's FFModel."""
    from flexflow_tpu import FFModel as JModel
    from flexflow_tpu_torch.model import _NOT_PORTED_METHODS

    tff = _torch_ff()
    public = {m for m in dir(JModel) if not m.startswith("_")}
    ported = {m for m in public if m in type(tff).__dict__}
    assert public - ported == set(_NOT_PORTED_METHODS)
    if method in _NOT_PORTED_METHODS:
        with pytest.raises(NotImplementedError,
                           match=_NOT_PORTED_METHODS[method].split()[0]):
            getattr(tff, method)()
    else:
        assert method in ported and callable(getattr(tff, method))
    with pytest.raises(AttributeError):
        tff.no_such_method
    tff.init_operators()
