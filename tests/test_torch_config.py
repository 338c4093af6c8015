"""The port's own copies of the reference package's host-only modules agree
with the originals: the configuration and its presets field for field, the
headline plan, the MATLAB-compatibility numerics bit for bit on seeded NumPy inputs, and
the TCP server statement for statement outside the statements of its one
repair."""

import ast
import dataclasses
import inspect

import numpy as np
import pytest

from se_snmf_nat_tpu import config as j_config
from se_snmf_nat_tpu import headline as j_headline
from se_snmf_nat_tpu.io import wavio as j_wavio
from se_snmf_nat_tpu.runtime import server as j_server
from se_snmf_nat_tpu.utils import matlab_compat as j_compat
from se_snmf_nat_tpu_torch import config as t_config
from se_snmf_nat_tpu_torch import headline as t_headline
from se_snmf_nat_tpu_torch.convert import config_from_jax
from se_snmf_nat_tpu_torch.io import wavio as t_wavio
from se_snmf_nat_tpu_torch.runtime import server as t_server
from se_snmf_nat_tpu_torch.utils import matlab_compat as t_compat

NAMES = ("default_config",) + tuple(j_config.PRESETS)


def _pair(name):
    if name == "default_config":
        return j_config.default_config(), t_config.default_config()
    return j_config.preset(name), t_config.preset(name)


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_reference(name):
    ref, port = _pair(name)
    assert isinstance(port, t_config.PipelineConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.delay == ref.delay
    for section in ("signal",):
        for prop in ("framelength", "frameshift", "fftlength", "n_bins",
                     "dc_bin", "dc_bin_back"):
            assert (getattr(getattr(port, section), prop)
                    == getattr(getattr(ref, section), prop)), prop


@pytest.mark.parametrize("name", NAMES)
def test_config_from_jax_round_trips(name):
    ref, port = _pair(name)
    carried = config_from_jax(ref)
    assert carried == port
    assert type(carried.signal) is t_config.SignalConfig
    assert config_from_jax(carried) == carried
    assert dataclasses.asdict(carried) == dataclasses.asdict(ref)


def test_config_from_jax_carries_edited_fields():
    ref = j_config.default_config()
    ref = ref.evolve(sep=dataclasses.replace(ref.sep, r_x=16, r_d=24),
                     adapt=dataclasses.replace(ref.adapt, adapt_train_n=False))
    got = config_from_jax(ref)
    assert (got.sep.r_x, got.sep.r_d, got.adapt.adapt_train_n) == (16, 24,
                                                                   False)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_presets_and_unknown_name():
    assert t_config.PRESETS == j_config.PRESETS
    with pytest.raises(KeyError):
        t_config.preset("no_such_preset")


def test_headline_plan_equals_reference():
    assert t_headline.HEADLINE_PLAN == j_headline.HEADLINE_PLAN
    assert t_headline.HEADLINE_BATCH == j_headline.HEADLINE_BATCH


@pytest.mark.parametrize("m,n,seed", [(200, 1, 1), (7, 5, 3), (1, 1, 12345)])
def test_matlab_v4_rand_matrix_bit_equal(m, n, seed):
    np.testing.assert_array_equal(t_compat.matlab_v4_rand_matrix(m, n, seed),
                                  j_compat.matlab_v4_rand_matrix(m, n, seed))


def test_matlab_twister_bit_equal():
    a, b = t_compat.MatlabTwister(0), j_compat.MatlabTwister(0)
    np.testing.assert_array_equal(a.rand(5, 3), b.rand(5, 3))
    np.testing.assert_array_equal(a.rand(4), b.rand(4))


def _samples(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 9000.0, 4096)
    x[:8] = [0.5, -0.5, 1.5, -2.5, 32767.5, -32768.5, 4e4, -4e4]
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_rounding_and_quantisers_bit_equal(seed):
    x = _samples(seed)
    np.testing.assert_array_equal(t_compat.matlab_round(x),
                                  j_compat.matlab_round(x))
    np.testing.assert_array_equal(t_compat.matlab_int16_write(x),
                                  j_compat.matlab_int16_write(x))
    np.testing.assert_array_equal(
        t_compat.matlab_wavwrite_quantize(x / 32767.0),
        j_compat.matlab_wavwrite_quantize(x / 32767.0))
    got = t_wavio.enhanced_quantize(x)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, j_wavio.enhanced_quantize(x))


# the port's repair of the server: the two methods it adds, the call that
# takes the place of the reference's plain abort, and the statements that
# mention the flushing transports
REPAIR_METHODS = {"EnhanceServer._abort_or_flush",
                  "EnhanceServer._abort_flushing"}
REPAIR_CALL = ("self._abort_or_flush(ln)", "ln.writer.transport.abort()")
REPAIR_NAME = "_flushing"


def _server_functions(module, without_repair=False):
    """{qualified name: ``ast.dump`` of the body without its docstring} for
    every function of the server module, and the module's other statements,
    with the fleet's import pointed at one package name.  With
    ``without_repair`` the repair is taken out again: its methods, its call
    (put back to the reference's abort) and every simple statement that
    names ``_flushing``."""
    src = inspect.getsource(module).replace("se_snmf_nat_tpu_torch",
                                            "se_snmf_nat_tpu")
    if without_repair:
        assert src.count(REPAIR_CALL[0]) == 1
        src = src.replace(*REPAIR_CALL)
    tree = ast.parse(src)
    funcs, rest = {}, []

    def body_of(node):
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body = body[1:]
        if without_repair:
            body = [n for n in body
                    if not (isinstance(n, (ast.Expr, ast.Assign,
                                           ast.AnnAssign))
                            and REPAIR_NAME in ast.dump(n))]
        return body

    def walk(nodes, prefix):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = prefix + node.name
                if without_repair and name in REPAIR_METHODS:
                    continue
                funcs[name] = (ast.dump(node.args)
                               + "".join(ast.dump(n) for n in body_of(node)))
                walk(body_of(node), name + ".")
            elif isinstance(node, ast.ClassDef):
                walk(body_of(node), prefix + node.name + ".")
            elif prefix == "":
                rest.append(ast.dump(node))

    walk(body_of(tree), "")
    return funcs, rest


def test_server_copy_equals_reference_outside_its_repair():
    """``runtime/server.py`` is the reference's file with the fleet imported
    from the port, a docstring that speaks of the card, and one repair: a
    drained lane's transport that is still flushing is left to flush until a
    deadline (``_abort_or_flush``, called where the reference aborts;
    ``_abort_flushing``, called by ``stop``; the two ``_flushing`` fields of
    ``__init__``).  With those statements taken out every function is the
    reference's, statement for statement; with them in, only the three
    functions that hold them differ."""
    ref, ref_rest = _server_functions(j_server)
    port, port_rest = _server_functions(t_server, without_repair=True)
    assert port_rest == ref_rest
    assert port == ref
    whole, _ = _server_functions(t_server)
    assert set(whole) - set(ref) == REPAIR_METHODS
    assert {name for name in ref if whole[name] != ref[name]} == {
        "EnhanceServer.__init__", "EnhanceServer.stop",
        "EnhanceServer._lane_housekeeping"}
    assert {"EnhanceServer", "enhance_over_socket"} <= set(dir(t_server))
