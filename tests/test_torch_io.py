"""The port's copies of the reference package's NumPy modules (wav and basis
files, splicing, smoothing, the training STFT, resampling, the training
data and features, k-means, the quality metrics, the multichannel fixture,
capture, the plots, the native library's bindings) agree with the originals:
statement for statement outside the import lines, and bit for bit on seeded
inputs.  ``tf_dd_torch`` matches ``tf_dd`` to 1e-12 in float64 (the same
operations in the same order: it is in fact exact)."""

import ast
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from se_snmf_nat_tpu.dsp import resample as j_resample
from se_snmf_nat_tpu.dsp import smoothing as j_smoothing
from se_snmf_nat_tpu.dsp import splice as j_splice
from se_snmf_nat_tpu.dsp import stft as j_stft
from se_snmf_nat_tpu.io import basis as j_basis
from se_snmf_nat_tpu.io import wavio as j_wavio
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.dsp import resample as t_resample
from se_snmf_nat_tpu_torch.dsp import smoothing as t_smoothing
from se_snmf_nat_tpu_torch.dsp import splice as t_splice
from se_snmf_nat_tpu_torch.dsp import stft as t_stft
from se_snmf_nat_tpu_torch.io import basis as t_basis
from se_snmf_nat_tpu_torch.io import wavio as t_wavio

ROOT = Path(__file__).resolve().parents[1]
FS = 16000

# (module path under both packages, the functions the port copies; None:
# every statement of the module; names after "-": all but these)
COPIES = [
    ("io/wavio.py", None),
    ("io/basis.py", ("-", "reference_basis_dir",
                     "load_reference_speech_noise")),
    ("dsp/splice.py", None),
    ("dsp/smoothing.py", ("tf_dd",)),
    ("dsp/stft.py", ("stft_batch_train",)),
    ("dsp/resample.py", None),
    ("train/vad.py", None),
    ("train/dataset.py", None),
    ("train/features.py", None),
    ("train/kmeans.py", None),
    ("metrics.py", None),
    ("bnmf/vb.py", ("init_train",)),
    ("bnmf/enhance.py", ("_EPS", "_FLR", "_WADA_SNRS", "_WADA_G",
                         "_WADA_POLY", "BnmfParams", "_safe_std", "_window",
                         "_frame", "spectrogram")),
    ("multichannel/fixture.py", None),
    ("multichannel/pmwf.py", ("PmwfParams",)),
    ("io/capture.py", None),
    ("utils/visualize.py", None),
    # the library's paths and its build differ (the port builds under
    # build/, never into native/); the names of both packages' are left out
    ("io/native.py", ("-", "_NATIVE_DIR", "_ROOT", "_SOURCE", "_LIB_PATH",
                      "_build")),
    # each of the port's stages is also a span (``runtime.profiling.span``)
    ("runtime/profiling.py", ("StageTimer",), None, ("span",)),
    ("runtime/grid.py", ("NOISE_TYPES", "SNR_LIST", "_lp", "synth_noise",
                         "_write")),
    ("cli.py", ("cmd_eval",)),
    # the process index and count come from torch.distributed
    ("parallel/distributed.py", ("shard_files_for_host",),
     {"jax.process_index": "_process_index",
      "jax.process_count": "_process_count"}),
]

# copies kept under a path of the port's own: (reference module, port
# module, the names copied)
MOVED_COPIES = [
    ("oracle/imcra_np.py", "enhance/imcra_params.py",
     ("_iround", "matlab_hanning", "matlab_hamming", "ImcraParams",
      "imcra_windows")),
    ("oracle/ms_np.py", "enhance/ms_params.py",
     ("_iround", "MsParams", "MsDerived", "_MH_TABLE", "mhvals",
      "ms_derived", "MsgParams")),
]


class _NoImports(ast.NodeTransformer):
    def visit_Import(self, node):
        return None

    def visit_ImportFrom(self, node):
        return None


class _Unwrap(ast.NodeTransformer):
    """``with name(...):`` blocks of the port replaced by their bodies, for
    the context managers ``names`` that the port adds around a copied
    body."""

    def __init__(self, names):
        self.names = names

    def visit_With(self, node):
        self.generic_visit(node)
        if len(node.items) == 1:
            call = node.items[0].context_expr
            if (isinstance(call, ast.Call) and isinstance(call.func, ast.Name)
                    and call.func.id in self.names):
                return node.body
        return node


class _Rename(ast.NodeTransformer):
    """``module.attr`` references of the reference turned into the port's
    own names (``{"module.attr": "name"}``)."""

    def __init__(self, names):
        self.names = names

    def visit_Attribute(self, node):
        if isinstance(node.value, ast.Name):
            new = self.names.get(f"{node.value.id}.{node.attr}")
            if new:
                return ast.Name(id=new, ctx=node.ctx)
        return self.generic_visit(node)


def _statements(path: Path, names, rename=None, unwrap=None):
    """{name: ``ast.dump``} of the module's top-level statements (functions,
    classes and assignments to one name by that name, the rest by position)
    without the module docstring and without any import line at any
    depth; ``rename`` maps the reference's ``module.attr`` references to
    the port's names; ``unwrap`` names the context managers whose ``with``
    blocks count as their bodies."""
    tree = _NoImports().visit(ast.parse(path.read_text()))
    if rename:
        tree = _Rename(rename).visit(tree)
    if unwrap:
        tree = ast.fix_missing_locations(_Unwrap(unwrap).visit(tree))
    body = tree.body
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)):
        body = body[1:]
    out = {}
    for i, node in enumerate(body):
        key = getattr(node, "name", f"<statement {i}>")
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            key = node.targets[0].id
        out[key] = ast.dump(node)
    if names is None:
        return out
    if names[0] == "-":
        return {k: v for k, v in out.items() if k not in names[1:]}
    return {k: out[k] for k in names}


@pytest.mark.parametrize("rel,names,rename,unwrap",
                         [c + (None,) * (4 - len(c)) for c in COPIES],
                         ids=[c[0] for c in COPIES])
def test_copy_equals_reference_outside_imports(rel, names, rename, unwrap):
    ref = _statements(ROOT / "se_snmf_nat_tpu" / rel, names, rename)
    port = _statements(ROOT / "se_snmf_nat_tpu_torch" / rel, names,
                       unwrap=unwrap)
    assert ref, rel
    assert port == ref


@pytest.mark.parametrize("ref_rel,port_rel,names", MOVED_COPIES,
                         ids=[c[1] for c in MOVED_COPIES])
def test_moved_copy_equals_reference_outside_imports(ref_rel, port_rel,
                                                     names):
    ref = _statements(ROOT / "se_snmf_nat_tpu" / ref_rel, names)
    port = _statements(ROOT / "se_snmf_nat_tpu_torch" / port_rel, names)
    assert port == ref


def test_grid_corpus_copy_equals_reference_outside_its_path():
    """``build_grid_corpus`` is the reference's but for one thing: the
    speech wav has no default (the reference's is a fixed path into the
    reference recordings)."""
    ref_tree = _NoImports().visit(ast.parse(
        (ROOT / "se_snmf_nat_tpu" / "runtime" / "grid.py").read_text()))
    fn = next(n for n in ref_tree.body if getattr(n, "name", None)
              == "build_grid_corpus")
    assert fn.args.kwonlyargs[-1].arg == "speech_wav"
    assert ast.dump(fn.args.kw_defaults[-1]) == ast.dump(
        ast.Name(id="SPEECH_SOURCE", ctx=ast.Load()))
    fn.args.kw_defaults[-1] = None
    port = _statements(ROOT / "se_snmf_nat_tpu_torch" / "runtime" / "grid.py",
                       ("build_grid_corpus",))
    assert port == {"build_grid_corpus": ast.dump(fn)}


def test_graft_entry_bases_copy_equals_reference_outside_its_docstring():
    def body(path):
        fn = next(n for n in ast.parse(path.read_text()).body
                  if getattr(n, "name", None) == "_tiny_bases")
        fn.body = fn.body[1:]                       # the docstring
        return ast.dump(fn)
    assert body(ROOT / "se_snmf_nat_tpu_torch" / "graft_entry.py") \
        == body(ROOT / "__graft_entry__.py")


# ---------------------------------------------------------------------------
# wav files
# ---------------------------------------------------------------------------

def _pcm(seed, n=4000, channels=1):
    rng = np.random.default_rng(seed)
    x = rng.integers(-32768, 32768, (channels, n) if channels > 1 else n)
    return x.astype(np.int16)


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_round_trip_across_packages(tmp_path, channels):
    x = _pcm(channels, channels=channels)
    for write, read, name in ((t_wavio.write_wav_int16,
                               j_wavio.read_wav_int16, "port"),
                              (j_wavio.write_wav_int16,
                               t_wavio.read_wav_int16, "ref")):
        path = tmp_path / f"{name}.wav"
        write(path, x, FS)
        got, fs = read(path)
        assert fs == FS and got.dtype == np.float64
        np.testing.assert_array_equal(got, x.astype(np.float64))
    assert (tmp_path / "port.wav").read_bytes() \
        == (tmp_path / "ref.wav").read_bytes()
    for mod in (t_wavio, j_wavio):
        got, _ = mod.read_wav_normalized(tmp_path / "port.wav")
        np.testing.assert_array_equal(got, x / 32768.0)


def test_write_enhanced_wav_and_header_equal_reference(tmp_path):
    y = np.random.default_rng(3).normal(0.0, 9000.0, 3000)
    y[:4] = [0.5, -0.5, 4e4, -4e4]
    t_wavio.write_enhanced_wav(tmp_path / "port.wav", y, FS)
    j_wavio.write_enhanced_wav(tmp_path / "ref.wav", y, FS)
    assert (tmp_path / "port.wav").read_bytes() \
        == (tmp_path / "ref.wav").read_bytes()
    got, _ = t_wavio.read_wav_int16(tmp_path / "port.wav")
    np.testing.assert_array_equal(got, t_wavio.enhanced_quantize(y))
    hdr = t_wavio.parse_wav_header(tmp_path / "port.wav")
    assert hdr == j_wavio.parse_wav_header(tmp_path / "port.wav")
    assert hdr["riff"] == b"RIFF" and hdr["wave"] == b"WAVE"
    assert hdr["size"] == struct.unpack(
        "<I", (tmp_path / "port.wav").read_bytes()[4:8])[0]
    assert t_wavio.raw_pcm_header_skip_bytes() \
        == j_wavio.raw_pcm_header_skip_bytes() == 44


def test_wav_refuses_what_the_reference_refuses(tmp_path):
    with pytest.raises(ValueError):
        t_wavio.write_wav_int16(tmp_path / "f.wav", np.zeros(4), FS)
    import wave
    with wave.open(str(tmp_path / "w8.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(1)
        w.setframerate(FS)
        w.writeframes(bytes(10))
    with pytest.raises(ValueError):
        t_wavio.read_wav_int16(tmp_path / "w8.wav")


def test_write_wav_dir_fixture(tmp_path):
    d = fixtures.write_wav_dir(tmp_path / "noise", "noise", 2, 0.5, seed=4)
    files = sorted(d.iterdir())
    assert [f.name for f in files] == ["noise_000.wav", "noise_001.wav"]
    x, fs = j_wavio.read_wav_int16(files[1])
    assert fs == FS
    np.testing.assert_array_equal(x, np.round(fixtures.noise(8000, seed=5)))


# ---------------------------------------------------------------------------
# dictionaries
# ---------------------------------------------------------------------------

def _pair(mod, seed, f=12, r=5):
    rng = np.random.default_rng(seed)
    return mod.BasisPair(b_dft=rng.random((f, r)), b_mel=rng.random((4, r)))


@pytest.mark.parametrize("r", [3, 5, 7, 12, 21])
def test_tiled_to_rank_equals_reference(r):
    got, want = _pair(t_basis, 0).tiled_to_rank(r), \
        _pair(j_basis, 0).tiled_to_rank(r)
    assert got.rank == want.rank == max(r, 5)
    np.testing.assert_array_equal(got.b_dft, want.b_dft)
    np.testing.assert_array_equal(got.b_mel, want.b_mel)


def test_npz_checkpoints_load_in_both_packages(tmp_path):
    t_basis.save_basis(tmp_path / "R_5.npz", _pair(t_basis, 1))
    j_basis.save_basis(tmp_path / "R_5_ref.npz", _pair(j_basis, 1))
    for path in (tmp_path / "R_5.npz", tmp_path / "R_5_ref.npz"):
        a, b = t_basis.load_basis(path), j_basis.load_basis(path)
        np.testing.assert_array_equal(a.b_dft, b.b_dft)
        np.testing.assert_array_equal(a.b_mel, b.b_mel)
        np.testing.assert_array_equal(a.b_dft, _pair(t_basis, 1).b_dft)


def test_mat_checkpoint_loads_in_both_packages(tmp_path):
    pair = _pair(t_basis, 2)
    sio.savemat(tmp_path / "R_5.mat", {"B_DFT_sub": pair.b_dft,
                                       "B_Mel_sub": pair.b_mel})
    for mod in (t_basis, j_basis):
        for got in (mod.load_basis(tmp_path / "R_5.mat"),
                    mod.load_basis_mat(tmp_path / "R_5.mat")):
            assert got.b_dft.dtype == np.float64
            np.testing.assert_array_equal(got.b_dft, pair.b_dft)
            np.testing.assert_array_equal(got.b_mel, pair.b_mel)


def test_reference_speech_noise_from_a_given_root(tmp_path):
    """The one difference of the copy: the reference repository's root is
    an argument.  The two dictionaries at the reference's layout load as
    the reference's ``load_basis_mat`` and ``tiled_to_rank`` give them."""
    conf = "TASLP_Splice0-SNMF_p2_DD0"
    speech, noise = _pair(t_basis, 3, r=100), _pair(t_basis, 4, r=40)
    for cls, pair in (("Clean_train_TIMIT_test", speech),
                      ("CHiME3_bgn_ch6", noise)):
        d = tmp_path / "basis" / cls / conf
        d.mkdir(parents=True)
        sio.savemat(d / "R_100.mat", {"B_DFT_sub": pair.b_dft,
                                      "B_Mel_sub": pair.b_mel})
    assert t_basis.reference_basis_dir(tmp_path) == tmp_path / "basis"
    got_s, got_n = t_basis.load_reference_speech_noise(100, root=tmp_path)
    want_n = j_basis.load_basis_mat(
        tmp_path / "basis" / "CHiME3_bgn_ch6" / conf / "R_100.mat"
    ).tiled_to_rank(100)
    np.testing.assert_array_equal(got_s.b_dft, speech.b_dft)
    np.testing.assert_array_equal(got_n.b_dft, want_n.b_dft)
    np.testing.assert_array_equal(got_n.b_mel, want_n.b_mel)
    assert got_n.rank == 100


# ---------------------------------------------------------------------------
# splicing, smoothing, the training STFT, resampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("splice", [0, 1, 2])
def test_frame_splice_bit_equal(splice):
    feat = np.random.default_rng(splice).random((7, 11))
    got = t_splice.frame_splice(feat, splice)
    np.testing.assert_array_equal(got, j_splice.frame_splice(feat, splice))
    assert got.shape == ((2 * splice + 1) * 7, 11)


def test_tf_dd_bit_equal_and_torch_counterpart():
    x = np.random.default_rng(5).random((9, 40))
    want = j_smoothing.tf_dd(x, 0.4)
    np.testing.assert_array_equal(t_smoothing.tf_dd(x, 0.4), want)
    got = t_smoothing.tf_dd_torch(torch.as_tensor(x.T), 0.4).numpy().T
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    jax_t = np.asarray(j_smoothing.tf_dd_jax(jnp.asarray(x.T), 0.4)).T
    np.testing.assert_allclose(got, jax_t, rtol=1e-12, atol=0)
    y1 = t_smoothing.tf_dd_torch(torch.as_tensor(x[0]), 0.4).numpy()
    np.testing.assert_array_equal(y1, want[0])


@pytest.mark.parametrize("preemph,dc_bin,n", [(0.0, 3, 9000),
                                               (0.97, 0, 4321),
                                               (0.0, 3, 900)])
def test_stft_batch_train_bit_equal(preemph, dc_bin, n):
    s = np.random.default_rng(6).normal(0.0, 3000.0, n)
    win = np.sqrt(0.5 * (1.0 - np.cos(2 * np.pi * np.arange(640) / 640)))
    args = (s, 640, 160, 1024, dc_bin, win, preemph)
    got, want = t_stft.stft_batch_train(*args), j_stft.stft_batch_train(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (513, n // 160)


@pytest.mark.parametrize("fs_out", [16000, 10000, 8000, 44100])
def test_srconv_bit_equal(fs_out):
    x = np.random.default_rng(7).normal(0.0, 1.0, 3217)
    got = t_resample.srconv(x, FS, fs_out)
    np.testing.assert_array_equal(got, j_resample.srconv(x, FS, fs_out))
    assert got.dtype == np.float64


# ---------------------------------------------------------------------------
# plots (the NumPy half; the PNG writers import matplotlib when called)
# ---------------------------------------------------------------------------

def test_spectrogram_and_ascii_plot_equal_reference():
    from se_snmf_nat_tpu.utils import visualize as j_visualize
    from se_snmf_nat_tpu_torch.utils import visualize as t_visualize
    x = np.random.default_rng(8).normal(0.0, 3000.0, 5000)
    for got, want in zip(t_visualize.power_spectrogram_db(x, FS),
                         j_visualize.power_spectrogram_db(x, FS)):
        np.testing.assert_array_equal(got, want)
    assert t_visualize.ascii_spectrogram(x, FS) \
        == j_visualize.ascii_spectrogram(x, FS)
