"""BaseModel config B (``--concat --reparam``: ``DecoderConcat``) against the
benchmark's plain reference, ``portbench/reference/base_b.serve.py``, and
the program's spans and counters of what B adds. No JAX.

On the CPU, at a small size (crop 32, dim 8, latent 4, 4 domains: the
decoder's widths 40 / 44 -> 22 / 26 -> 13 / 17, none a multiple of 32, as
268 / 276 / 146 / 81 are not at full width), on seeded random weights from
``portbench.common.make_weights``, which the port and the reference take
under the same state_dict keys:

- f32 float against ``Arith()``: within 1e-4 of max(1, max |reference|).
  The two sum the same f32 products in other orders (the port's norms take
  their statistics from f64 sums), which moves an output by a few 1e-6.
- int8 at f32 compute against ``Arith(bits=8)`` with the amax that
  ``nets.calibrate`` derives from the calibration batches the port's
  ``calibrate_int8`` takes: the amax within 1e-5 relative (both are the
  same maxima of f32 maps); each image's RMS gap at most 0.05. The port
  applies a deferred norm as one affine in the next conv's quantize
  prologue, which rounds otherwise than the reference's (x - mean) *
  rsqrt(var + eps): a value at a .5 boundary then quantizes to the other
  integer, moves its image's later norm statistics and so its later
  roundings. Over seeds 10-21 an image moved by 0-0.0166 RMS, up to 0.12 at
  one output; the int4 reference lies 0.247-0.354 RMS from the int8 one.
- the control: ``Arith(bits=4)`` in the program's place fails that bound.
- the int8 route that hands ``dec3``'s LayerNorm and relu to the head
  (kernel 8's plain version, z's share of the 1x1 sum as a per-image term)
  against the same model on the unfused route (``dec3`` without
  ``defer_norm``: the LayerNorm applied, z concatenated, ``dec4`` as a
  conv): f32 within the f32 bound above, bf16 within ``head.BF16_TOL`` (the
  same rounding points; the sums over the channels in other orders). The counters then read one
  call with a term and the last concat's bytes fewer.

The card test (``gpu``, skipped here) counts the int8 conv launches that run
a tail N tile in one forward of each configuration at full width.

    python -m pytest --noconftest tests/test_torch_base_b_reference.py -m gpu -q
"""
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from masterthesis_tpu_torch.arguments import default_test_args  # noqa: E402
from masterthesis_tpu_torch.models import AdaINModel, BaseModel  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import head as khead  # noqa: E402
from masterthesis_tpu_torch.utils import profiling  # noqa: E402
from portbench import common, readings  # noqa: E402
from portbench import run as pbrun  # noqa: E402
from portbench.reference import nets  # noqa: E402

torch.set_num_threads(2)

SIZE, B, K, LATENT = 32, 4, 4, 4
SHAPE = dict(crop_size=SIZE, dim=8, latent_dim=LATENT, num_domains=K, batch_size=B, seed=0,
             concat=True, reparam=True)
REFERENCE = ROOT / "portbench" / "reference" / "base_b.serve.py"
CELL = "base_b_256.serve_int8_b64"
# the five concats at the small size: (channels out, height)
CONCATS = [(36, 8), (40, 8), (44, 8), (26, 16), (17, 32)]


def _reference():
    return common.load_module(REFERENCE, "portbench_reference_base_b_serve")


def _model(seed: int, dtype: str = "float32"):
    model = BaseModel(default_test_args(**SHAPE, compute_dtype=dtype), device="cpu")
    weights = common.make_weights(model.nets, seed, torch.device("cpu"))
    model.load_params(weights)
    return model, weights


def _batches(seed: int, n: int):
    gen = torch.Generator().manual_seed(seed)
    return [common.request_batch(gen, B, SIZE, LATENT, K, "cpu") for _ in range(n)]


def _int8_close(got, want) -> bool:
    return float((got.float() - want).square().mean(dim=(1, 2, 3)).sqrt().max()) <= 0.05


@pytest.fixture
def recorder():
    profiling.drain()
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
        profiling.drain()


def test_loading_the_reference_loads_nothing_of_the_program_or_jax():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "from portbench import common\n"
            f"common.load_module(common.HERE / 'reference' / 'base_b.serve.py', 'ref')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not loaded & {*common.FORBIDDEN, common.PORT}, loaded


@pytest.mark.parametrize("seed", [11, 4_294_967_311])
def test_the_f32_forward_matches_the_reference(seed):
    model, weights = _model(seed)
    b = _batches(seed, 1)[0]
    got, _, _ = model.forward_random(b["img"], b["z"], b["c"])
    with nets.exact_f32(), torch.no_grad():
        want = _reference().forward_random(weights, b["img"], b["z"], b["c"], nets.Arith())
    assert got.shape == want.shape == (B, SIZE, SIZE, 3)
    assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


def _calibrated(seed: int):
    model, weights = _model(seed)
    *calib, b = _batches(seed, 3)
    model.calibrate_int8([c["img"] for c in calib], [c["c"] for c in calib],
                         [c["z"] for c in calib])
    got, _, _ = model.forward_random(b["img"], b["z"], b["c"])
    with nets.exact_f32(), torch.no_grad():
        amax = nets.calibrate(_reference().forward_random, weights, calib)
    return model, weights, amax, b, got


def test_the_int8_forward_matches_the_int8_reference_with_the_same_amax():
    model, weights, amax, b, got = _calibrated(12)
    # the reference's keys are the port's module paths: "ce." the content
    # encoder's, "dec." the decoder's (each quantized conv's input, as the
    # port's amax_in of <path>.conv)
    nets_of = {"ce": "content_encoder", "dec": "decoder"}
    assert len(amax) == 20  # 10 encoder convs, 8 decoder resblock convs, 2 upsamples
    for key, value in amax.items():
        net, path = key.split(".", 1)
        port = float(model.quant[nets_of[net]][f"{path}.conv.amax_in"])
        assert abs(port - float(value)) <= 1e-5 * float(value), key
    with nets.exact_f32(), torch.no_grad():
        want = _reference().forward_random(weights, b["img"], b["z"], b["c"],
                                           nets.Arith(bits=8, amax=amax))
    assert _int8_close(got, want)


def test_the_int4_control_fails_the_int8_bound():
    _, weights, amax, b, got = _calibrated(13)
    with nets.exact_f32(), torch.no_grad():
        ref = _reference()
        want = ref.forward_random(weights, b["img"], b["z"], b["c"], nets.Arith(bits=8, amax=amax))
        control = ref.forward_random(weights, b["img"], b["z"], b["c"],
                                     nets.Arith(bits=4, amax=amax))
    assert _int8_close(got, want) and not _int8_close(control, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_concat_spans_and_their_bytes(dtype, recorder):
    model, _ = _model(14, dtype)
    b = _batches(14, 1)[0]
    before = profiling.totals().get("decode.concat_bytes", 0)
    profiling.drain()
    model.forward_random(b["img"], b["z"], b["c"])
    spans = profiling.drain()
    concats = [s for s in spans if s[0] == "mt.decode.concat"]
    assert [(s[6]["channels"], s[6]["height"]) for s in concats] == CONCATS
    decode = next(i for i, s in enumerate(spans) if s[0] == "mt.decode")
    assert all(s[4] == decode for s in concats)
    size = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    want = sum(B * c * h * h * size for c, h in CONCATS)
    assert profiling.totals()["decode.concat_bytes"] - before == want


def _int8_model(seed: int, dtype: str):
    model, _ = _model(seed, dtype)
    calib, b = _batches(seed, 2)
    model.calibrate_int8([calib["img"]], [calib["c"]], [calib["z"]])
    return model, b


def _unfused_forward_random(model, img, z, c):
    """``forward_random``'s int8 route with ``dec3`` called without
    ``defer_norm``: it applies its LayerNorm and relu, z is concatenated
    after it, and ``dec4`` runs as a 1x1 transposed conv."""
    dec = model.nets.decoder
    h = model.encode_content(img.permute(0, 3, 1, 2).contiguous())
    h = dec._concat(dec._concat(dec.dec_share(h), c), z)
    for i in range(dec.n_blocks):
        h = getattr(dec, f"dec1_{i}")(h)
    h = dec.dec3(dec._concat(dec.dec2(dec._concat(h, z)), z))
    return dec.dec4(dec._concat(h, z)).permute(0, 2, 3, 1).contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_int8_route_through_the_head_matches_the_unfused_route(dtype, monkeypatch):
    model, b = _int8_model(16, dtype)
    calls = []
    real = khead.head
    monkeypatch.setattr(khead, "head", lambda *a: calls.append(a) or real(*a))
    got, _, _ = model.forward_random(b["img"], b["z"], b["c"])
    assert len(calls) == 1 and calls[0][5].shape == (B, 3)
    want, _, _ = model._timed(lambda *a: _unfused_forward_random(model, *a), b["img"], b["z"],
                              b["c"])
    assert len(calls) == 1
    tol = 1e-4 * max(1.0, float(want.abs().max())) if dtype == "float32" else khead.BF16_TOL
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("block", ["dec3", "dec4"])
def test_a_code_goes_only_to_a_head_with_a_pending_norm(block):
    """An upsample that would not take the code as kernel 8's term (a
    transposed 3x3 conv; the head with no pending norm) refuses it rather
    than drop z's channels."""
    dec = _model(18)[0].nets.decoder
    up = getattr(dec, block)
    x = torch.zeros(B, up.conv.weight.shape[0], 4, 4)
    with pytest.raises(ValueError, match="code"):
        up(x, code=torch.zeros(B, LATENT))


@pytest.mark.parametrize("path", ["float", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_head_term_and_concat_counters_by_route(dtype, path, recorder):
    """One head call with a term and four concats a forward on the int8
    route; none and five on the float route."""
    model, b = _int8_model(17, dtype) if path == "int8" else (_model(17, dtype)[0],
                                                              _batches(17, 1)[0])
    before = profiling.totals()
    profiling.drain()
    model.forward_random(b["img"], b["z"], b["c"])
    concats = [s for s in profiling.drain() if s[0] == "mt.decode.concat"]
    after = profiling.totals()
    size = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    kept = CONCATS[:-1] if path == "int8" else CONCATS
    assert [(s[6]["channels"], s[6]["height"]) for s in concats] == kept
    got = {k: after.get(k, 0) - before.get(k, 0)
           for k in ("head.term_launches", "decode.concat_bytes")}
    assert got == {"head.term_launches": int(path == "int8"),
                   "decode.concat_bytes": sum(B * c * h * h * size for c, h in kept)}


def test_with_the_recorder_off_the_concats_record_and_count_nothing():
    assert not profiling.ON
    model, _ = _model(15)
    b = _batches(15, 1)[0]
    profiling.drain()
    before = profiling.totals()
    model.forward_random(b["img"], b["z"], b["c"])
    assert profiling.drain() == [] and profiling.totals() == before


def _small_cell():
    cell = common.resolve(CELL)
    cell.config = dict(cell.config, flags=dict(cell.config["flags"], crop_size=64, dim=16,
                                               latent_dim=4))
    cell.traffic = dict(cell.traffic, batch=4, pool=4, calibration_batch=4, warmup_requests=1,
                        checked_requests=3, check_block=4, trace_seconds=0.2)
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_of_the_cell_is_correct(trace, monkeypatch):
    # this suite's conftest loads JAX into the process, which the run's
    # import guard refuses (portbench/tests runs it without)
    monkeypatch.setattr(pbrun, "guard", lambda when: None)
    r = pbrun.run_cell(CELL, 3_000_000_019, 0.3, trace, device="cpu", cell=_small_cell(),
                       t0=time.perf_counter())
    assert r["correct"], r["compared"]
    if trace:  # the CPU's kernel window has no device time: the rooflines read nothing
        assert "resblock_roofline.serve" not in r["per_layer"]
        assert "deconv_roofline.serve" not in r["per_layer"]
        assert r["summary"].kernels["int8_resblock"]["calls"] > 0


def test_the_cells_control_fails_its_limit():
    cell = _small_cell()
    got = readings.serve_reading(cell, 3_000_000_021, torch.device("cpu"), control=True)
    assert got["worst_image_rmse"] > cell.limits["worst_image_rmse"], got


# ------------------------------------------------------------------ the card --

FULL = dict(crop_size=32, dim=64, latent_dim=8, num_domains=4, batch_size=2, seed=0,
            compute_dtype="bfloat16")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run with -m gpu on the card")
    return torch.device("cuda")


def _tail_launches(model, device) -> dict:
    """The tail launches of one int8 forward of ``model``, by counter."""
    gen = torch.Generator(device=device).manual_seed(5)
    b = common.request_batch(gen, 2, 32, model.latent_dim, 4, device)
    model.calibrate_int8([b["img"]], [b["c"]], [b["z"]])
    profiling.enable()
    try:
        before = profiling.totals()
        model.forward_random(b["img"], b["z"], b["c"])
        after = profiling.totals()
    finally:
        profiling.disable()
        profiling.drain()
    return {k: n - before.get(k, 0) for k, n in after.items() if k.endswith(".tail_launches")}


@pytest.mark.gpu
def test_the_tail_launches_of_one_b_forward_are_the_librarys_split(cuda):
    """Kernel 6 at 268 channels splits each conv's N tiles as (256, 12), kernel
    5's phase rows 552 and 292 as (512, 40) and (256, 36): one tail launch
    for each of the six 268-wide convs and each of the two upsamples."""
    from masterthesis_tpu_torch.ops.kernels import int8_conv as kq

    model = BaseModel(default_test_args(**FULL, concat=True, reparam=True), device=cuda)
    got = _tail_launches(model, cuda)
    dec = model.nets.decoder
    assert kq.conv_launches(dec.dec1_0.conv1.conv.quant()) == (256, 12)
    assert kq.conv_launches(dec.dec_share.conv1.conv.quant()) == (256,)
    assert kq.conv_launches(dec.dec2.conv.quant()) == (512, 40)
    assert kq.conv_launches(dec.dec3.conv.quant()) == (256, 36)
    assert got == {"int8_downconv.tail_launches": 0, "int8_resblock.tail_launches": 6,
                   "int8_deconv.tail_launches": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["adain", "base_a"])
def test_no_tail_launches_at_the_aligned_widths(cuda, config):
    args = default_test_args(**FULL)
    model = AdaINModel(args, device=cuda) if config == "adain" else BaseModel(args, device=cuda)
    got = _tail_launches(model, cuda)
    assert got and all(n == 0 for n in got.values()), got
