"""The port's int4 wire format against the JAX package's: the plain
``nibble_pack``/``nibble_unpack`` and the symmetric quantizer of
``repro_torch.kernels.ref`` against ``repro.kernels.ref`` and the Pallas
kernels of ``repro.kernels.quant`` (interpret mode, as
``tests/test_wire_quant.py`` runs them).

Tolerance: none.  Codes, scales and packed bytes are integers or a single
IEEE float32 division/multiplication on identical inputs, so every check
is bit-exact.  The CUDA kernels are held bit-exactly against the plain
version by the ``cuda``-marked tests (skipped without a card) and by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro_torch.kernels import ops, quant, ref


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: parallel test workers that each
    run a full intra-op pool starve each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ALL_CODES = np.arange(-128, 128, dtype=np.int8)      # out-of-range included
ALL_BYTES = np.arange(256, dtype=np.uint8)


def _codes(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 8, shape).astype(np.int8)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 3, 129, 256])
def test_nibble_pack_all_code_values(n):
    """Every int8 value, in range or not: the low nibble is what is kept."""
    c = np.resize(ALL_CODES, n)
    _same(ref.nibble_pack(torch.tensor(c)), jref.nibble_pack(jnp.asarray(c)))


@pytest.mark.parametrize("n", [511, 512])
def test_nibble_unpack_all_byte_values(n):
    _same(ref.nibble_unpack(torch.tensor(ALL_BYTES), n),
          jref.nibble_unpack(jnp.asarray(ALL_BYTES), n))


@pytest.mark.parametrize("shape", [(4, 1001), (2, 3, 64), (3, 1), (5, 2)])
def test_nibble_batched_roundtrip(shape):
    """Leading dims batch, as the reference does on the gathered payload."""
    c = _codes(shape, seed=sum(shape))
    packed = ref.nibble_pack(torch.tensor(c))
    _same(packed, jref.nibble_pack(jnp.asarray(c)))
    n = shape[-1]
    _same(ref.nibble_unpack(packed, n),
          jref.nibble_unpack(jnp.asarray(packed.numpy()), n))
    _same(ref.nibble_unpack(packed, n), c)


@pytest.mark.parametrize("n", [1, 257, 1001])
def test_nibble_matches_pallas_interpret(n):
    """Against the Pallas kernels themselves (1-D: the kernel's contract)."""
    c = _codes((n,), seed=n)
    packed = jquant.nibble_pack(jnp.asarray(c), interpret=True)
    _same(ref.nibble_pack(torch.tensor(c)), packed)
    _same(ref.nibble_unpack(torch.tensor(np.asarray(packed)), n),
          jquant.nibble_unpack(packed, n, interpret=True))


def _at_offset(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts ``offset`` bytes into a larger
    buffer, as ``chip_smoke.at_offset`` builds the kernels' misaligned
    inputs."""
    buf = torch.zeros(x.numel() + offset + 16, dtype=torch.uint8)
    view = buf[offset:offset + x.numel()].view(x.dtype).view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.storage_offset() == offset
    return view


# the misaligned starts and ragged rows chip_smoke holds the kernels to,
# at small n: (16, 1023) and (16, 1024) stand for (16, 857087) and
# (16, 857088), 16 workers' Top-K chunk
OFFSETS = [1, 8, 15]
OFFSET_SHAPES = [(4099,), (3, 4096), (3, 1001)]
RAGGED_SHAPES = [(3, 1001), (16, 1023), (16, 1024), (2, 1024), (4, 1001)]


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("shape", OFFSET_SHAPES)
def test_nibble_plain_at_byte_offsets(shape, offset):
    """Views at odd byte offsets of a larger buffer, row by row against the
    reference, both ways, every int8 value."""
    c = np.resize(ALL_CODES, shape)
    view = _at_offset(torch.tensor(c), offset)
    packed = ref.nibble_pack(view)
    packed_view = _at_offset(packed, offset)
    n = shape[-1]
    unpacked = ref.nibble_unpack(packed_view, n)
    for i, row in enumerate(c.reshape(-1, n)):
        want = jref.nibble_pack(jnp.asarray(row))
        _same(packed.reshape(-1, packed.shape[-1])[i], want)
        _same(unpacked.reshape(-1, n)[i], jref.nibble_unpack(want, n))


@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_nibble_plain_multirow_odd_shapes(shape):
    """Multi-row shapes whose rows are not a multiple of 32 codes, row by
    row against the reference."""
    c = np.resize(ALL_CODES[::-1], shape)
    packed = ref.nibble_pack(torch.tensor(c))
    n = shape[-1]
    for i, row in enumerate(c):
        want = jref.nibble_pack(jnp.asarray(row))
        _same(packed[i], want)
        _same(ref.nibble_unpack(packed[i], n), jref.nibble_unpack(want, n))


@pytest.mark.parametrize("shape", RAGGED_SHAPES + OFFSET_SHAPES)
def test_nibble_roundtrip_chip_smoke_shapes(shape):
    """Codes in [-8, 7] come back as they went; any other int8 value comes
    back as its low nibble, sign-extended."""
    c = _codes(shape, seed=shape[-1])
    packed = ref.nibble_pack(torch.tensor(c))
    assert packed.shape == shape[:-1] + ((shape[-1] + 1) // 2,)
    _same(ref.nibble_unpack(packed, shape[-1]), c)
    wide = np.resize(ALL_CODES, shape)
    low = (wide.astype(np.int16) & 0xF).astype(np.int8)
    _same(ref.nibble_unpack(ref.nibble_pack(torch.tensor(wide)), shape[-1]),
          np.where(low >= 8, low - 16, low).astype(np.int8))


def _float_rows(seed):
    """Rows that hit the quantizer's edge cases: random values, exact
    half-way points of the int4 grid, zeros and an all-zero row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((5, 97)).astype(np.float32)
    x[1, :15] = np.arange(-7, 8) + 0.5            # round half to even
    x[1, 15] = 7.0                                 # sets the scale to 1
    x[2, ::3] = 0.0
    x[3] = 0.0
    x[4] *= 1e-30                                  # tiny but non-zero
    return x


@pytest.mark.parametrize("qmax", [7, 127])
def test_quantizer_matches_reference_bitexact(qmax):
    x = _float_rows(qmax)
    sc = ref.quant_scale(torch.tensor(x), qmax)
    codes = ref.quantize(torch.tensor(x), sc.unsqueeze(-1), qmax)
    deq = ref.dequantize(codes, sc.unsqueeze(-1))
    for i, row in enumerate(x):
        jsc = jref.quant_scale(jnp.asarray(row), qmax)
        jcodes = jref.quantize(jnp.asarray(row), jsc, qmax)
        _same(sc[i], jsc)
        _same(codes[i], jcodes)
        _same(deq[i], jref.dequantize(jcodes, jsc))
    assert sc[3].item() == 1.0 and not codes[3].any()


def test_ops_dispatch_cpu_to_plain_and_never_launch():
    quant.reset_launches()
    c = torch.tensor(_codes((3, 33), seed=1))
    packed = ops.nibble_pack(c)
    assert torch.equal(packed, ref.nibble_pack(c))
    assert torch.equal(ops.nibble_unpack(packed, 33), c)
    assert quant.LAUNCHES == {"nibble_pack": 0, "nibble_unpack": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch or raise; they never compute on the CPU."""
    quant.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        quant.nibble_pack(torch.zeros(8, dtype=torch.int8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        quant.nibble_unpack(torch.zeros(4, dtype=torch.uint8), 8)
    assert quant.LAUNCHES == {"nibble_pack": 0, "nibble_unpack": 0}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1,), (2,), (3,), (129,), (2**20 + 1,),
                                   (4, 1001), (2, 857088), (3, 31), (7, 64)])
def test_cuda_nibble_kernels_match_plain(shape):
    dev = _cuda()
    c = torch.tensor(np.resize(ALL_CODES, shape), device=dev)
    packed = quant.nibble_pack(c)
    assert torch.equal(packed, ref.nibble_pack(c))
    n = shape[-1]
    assert torch.equal(quant.nibble_unpack(packed, n), ref.nibble_unpack(packed, n))


@pytest.mark.cuda
def test_cuda_nibble_unpack_all_bytes():
    dev = _cuda()
    b = torch.tensor(ALL_BYTES, device=dev)
    for n in (511, 512):
        assert torch.equal(quant.nibble_unpack(b, n), ref.nibble_unpack(b, n))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("shape", OFFSET_SHAPES + [(16, 857088)])
def test_cuda_nibble_kernels_misaligned(shape, offset):
    """Inputs that start 1, 8 or 15 bytes past a 16-byte boundary: every
    row takes the byte path."""
    dev = _cuda()
    c = torch.tensor(np.resize(ALL_CODES, shape), device=dev)
    view = torch.empty(c.numel() + offset, dtype=torch.int8, device=dev)[offset:]
    view = view.view(shape)
    view.copy_(c)
    assert view.data_ptr() % 16 == offset
    assert torch.equal(quant.nibble_pack(view), ref.nibble_pack(c))
    packed = ref.nibble_pack(c)
    pview = torch.empty(packed.numel() + offset, dtype=torch.uint8,
                        device=dev)[offset:].view(packed.shape)
    pview.copy_(packed)
    n = shape[-1]
    assert torch.equal(quant.nibble_unpack(pview, n), ref.nibble_unpack(packed, n))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 1001), (16, 857087), (16, 857088)])
def test_cuda_nibble_kernels_ragged_rows(shape):
    dev = _cuda()
    c = torch.tensor(np.resize(ALL_CODES[::-1], shape), device=dev)
    packed = quant.nibble_pack(c)
    assert torch.equal(packed, ref.nibble_pack(c))
    n = shape[-1]
    assert torch.equal(quant.nibble_unpack(packed, n), ref.nibble_unpack(packed, n))
