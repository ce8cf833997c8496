"""The port's PQ and BQ quantizers, their kernels' plain versions and the
code-domain HNSW search, against the JAX package.

Quantizer training draws from ``jax.random`` in the JAX package and from a
``torch.Generator`` in the port, so parity is held by loading the JAX
codebooks / hyperplanes / mean into the port: then codes, bits, packed words
and Hamming distances are equal exactly, LUTs and ADC distances to rtol
1e-5.  The port's own training is held to shape and quantization error.
The plain versions of ``beam_gather_adc``, ``beam_gather_hamming``,
``pq_adc`` and ``hamming`` are held to ``repro.kernels.ref`` and to the
Pallas kernels in interpret mode.  On the JAX engine's graph and codes, the
port's Hamming search returns the JAX ids and iteration counts exactly; the
ADC search the same ids, up to candidates whose ADC distances tie within
float rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bq as jbq
from repro.core import pq as jpq
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import QuantixarEngine as JEngine
from repro.core.hnsw_build import HNSWConfig as JHNSWConfig
from repro.core.hnsw_build import preprocess_vectors
from repro.core.hnsw_search import search as j_search
from repro.data.synthetic import gaussian_mixture
from repro.kernels import ref as jref
from repro.kernels.beam_gather import (beam_gather_adc_kernel,
                                       beam_gather_hamming_kernel)
from repro.kernels.hamming import hamming_kernel
from repro.kernels.pq_adc import pq_adc_kernel
from repro_torch.core import bq as pbq
from repro_torch.core import pq as ppq
from repro_torch.core.hnsw_build import HNSWConfig, PackedHNSW
from repro_torch.core.hnsw_search import search, to_device
from repro_torch.kernels import beam_gather_adc as bga_mod
from repro_torch.kernels import beam_gather_hamming as bgh_mod
from repro_torch.kernels import hamming as hm_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pq_adc as adc_mod

N, DIM = 600, 24
ADC_TOL = dict(rtol=1e-5, atol=1e-5)   # the JAX package's own ADC tolerance


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _words(rng, n, w):
    """uint32 words with the high bit set often, all-ones and all-zeros
    rows; returns (uint32 array, the port's int32 view)."""
    words = rng.randint(0, 2 ** 32, (n, w), dtype=np.uint64).astype(np.uint32)
    words[::5] = 0xFFFFFFFF
    words[1::5] = 0
    return words, pbq.from_uint32(words)


@pytest.fixture(scope="module")
def data():
    x = gaussian_mixture(N, DIM, n_clusters=12, scale=0.3, seed=4)
    q = gaussian_mixture(20, DIM, n_clusters=12, scale=0.3, seed=5)
    return x, q


# ---------------------------------------------------------------------------
# PQ
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["l2", "cosine"])
def pqs(request, data):
    """(JAX ProductQuantizer, the port's with the JAX codebooks loaded)."""
    x, _ = data
    cfg = dict(m=6, k=32, iters=5, metric=request.param)
    jq = jpq.ProductQuantizer(jpq.PQConfig(**cfg))
    jq.train(jnp.asarray(x), seed=0)
    pq = ppq.ProductQuantizer(ppq.PQConfig(**cfg), device="cpu")
    pq.load_state_dict(jq.state_dict())
    return jq, pq


class TestPQ:
    def test_encode_decode_match(self, pqs, data):
        jq, pq = pqs
        x, _ = data
        codes = pq.encode(x)
        want = np.asarray(jq.encode(jnp.asarray(x)))
        assert codes.dtype == torch.uint8
        np.testing.assert_array_equal(codes.numpy(), want)
        np.testing.assert_array_equal(pq.decode(codes).numpy(),
                                      np.asarray(jq.decode(jnp.asarray(want))))

    def test_lut_and_adc_match(self, pqs, data):
        jq, pq = pqs
        x, q = data
        jlut = jpq.build_adc_lut(jnp.asarray(q), jq.codebooks,
                                 normalize_inputs=jq._norm())
        lut = pq.lut(q)
        np.testing.assert_allclose(lut.numpy(), np.asarray(jlut), **ADC_TOL)
        codes = pq.encode(x)
        np.testing.assert_allclose(
            ppq.adc_distances(lut, codes).numpy(),
            np.asarray(jpq.adc_distances(jlut, jnp.asarray(codes.numpy()))),
            **ADC_TOL)

    @pytest.mark.parametrize("chunk", [None, 64, 599])
    def test_adc_topk_chunked(self, pqs, data, chunk):
        """Chunked top-k equals the JAX top-k over the whole scan; codes
        repeat, so equal ADC distances tie and go to the lowest row."""
        jq, pq = pqs
        x, q = data
        codes = pq.encode(x)
        jd, ji = jpq.adc_topk(jpq.build_adc_lut(
            jnp.asarray(q), jq.codebooks, normalize_inputs=jq._norm()),
            jnp.asarray(codes.numpy()), 25)
        d, i = ppq.adc_topk(pq.lut(q), codes, 25, chunk=chunk)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), **ADC_TOL)

    def test_cosine_normalises_inside(self, data):
        """Under cosine a vector and any positive multiple share a code."""
        x, _ = data
        pq = ppq.ProductQuantizer(ppq.PQConfig(m=6, k=32, iters=5,
                                               metric="cosine"), device="cpu")
        pq.train(x, seed=0)
        np.testing.assert_array_equal(pq.encode(x).numpy(),
                                      pq.encode(x * 7.5).numpy())

    def test_own_training(self, data):
        """The port's codebooks have the JAX shape, and its quantization
        error is within 10 % of the JAX codebooks' on the same data (the
        seeds differ, the Lloyd steps are the same)."""
        x, _ = data
        cfg = dict(m=6, k=32, iters=10)
        jq = jpq.ProductQuantizer(jpq.PQConfig(**cfg))
        jq.train(jnp.asarray(x), seed=0)
        pq = ppq.ProductQuantizer(ppq.PQConfig(**cfg), device="cpu")
        pq.train(x, seed=0)
        assert pq.codebooks.shape == jq.codebooks.shape == (6, 32, 4)

        def err(recon):
            return float(((np.asarray(recon) - x) ** 2).sum(1).mean())
        e_jax = err(jq.decode(jq.encode(jnp.asarray(x))))
        e_port = err(pq.decode(pq.encode(x)))
        assert e_port <= 1.1 * e_jax, (e_port, e_jax)

    def test_wide_codebook_int32_codes(self, data):
        """k > 256: the port keeps int32 codes where JAX keeps uint16."""
        x, _ = data
        cfg = dict(m=4, k=300, iters=2)
        jq = jpq.ProductQuantizer(jpq.PQConfig(**cfg))
        jq.train(jnp.asarray(x), seed=0)
        pq = ppq.ProductQuantizer(ppq.PQConfig(**cfg), device="cpu")
        pq.load_state_dict(jq.state_dict())
        codes = pq.encode(x)
        want = np.asarray(jq.encode(jnp.asarray(x)))
        assert codes.dtype == torch.int32 and want.dtype == np.uint16
        np.testing.assert_array_equal(codes.numpy(), want)
        assert pq.compression_ratio(DIM) == jq.compression_ratio(DIM)

    def test_search_matches(self, pqs, data):
        jq, pq = pqs
        x, q = data
        jd, ji = jq.search(jq.encode(jnp.asarray(x)), jnp.asarray(q), 10)
        d, i = pq.search(pq.encode(x), q, 10)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), **ADC_TOL)

    def test_state_dict_round_trip(self, pqs, data):
        jq, pq = pqs
        x, _ = data
        back = jpq.ProductQuantizer(jq.config)
        back.load_state_dict(pq.state_dict())
        np.testing.assert_array_equal(np.asarray(back.encode(jnp.asarray(x))),
                                      pq.encode(x).numpy())


# ---------------------------------------------------------------------------
# BQ
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bqs(data):
    x, _ = data
    jq = jbq.BinaryQuantizer(jbq.BQConfig(bits=64))
    jq.train(jnp.asarray(x), seed=0)
    bq = pbq.BinaryQuantizer(pbq.BQConfig(bits=64), device="cpu")
    bq.load_state_dict(jq.state_dict())
    return jq, bq


class TestBQ:
    def test_bits_and_words_match(self, bqs, data):
        jq, bq = bqs
        x, _ = data
        jbits = jbq.project_bits(jnp.asarray(x), jq.hyperplanes, jq.mean)
        bits = pbq.project_bits(_t(x), bq.hyperplanes, bq.mean)
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
        words = bq.encode(x)
        want = np.asarray(jq.encode(jnp.asarray(x)))
        assert words.dtype == torch.int32 and want.dtype == np.uint32
        np.testing.assert_array_equal(pbq.to_uint32(words), want)
        np.testing.assert_array_equal(
            pbq.unpack_bits(words, 64).numpy(),
            np.asarray(jbq.unpack_bits(jnp.asarray(want), 64)))

    def test_words_round_trip_through_int32(self):
        words, view = _words(np.random.RandomState(0), 40, 3)
        assert (view < 0).any()                  # high bits land negative
        np.testing.assert_array_equal(pbq.to_uint32(_t(view)), words)
        bits = np.asarray(jbq.unpack_bits(jnp.asarray(words), 96))
        packed = pbq.pack_bits(_t(bits))
        np.testing.assert_array_equal(packed.numpy(), view)
        np.testing.assert_array_equal(pbq.unpack_bits(packed, 96).numpy(),
                                      bits)

    def test_hamming_matches(self, bqs, data):
        jq, bq = bqs
        x, q = data
        jd = jbq.hamming_distances(jq.encode(jnp.asarray(q)),
                                   jq.encode(jnp.asarray(x)))
        d = pbq.hamming_distances(bq.encode(q), bq.encode(x))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))

    @pytest.mark.parametrize("chunk", [None, 50, 600])
    def test_hamming_topk_ties_go_to_lowest_row(self, bqs, data, chunk):
        """Hamming distances are small integers with many ties: the
        chunked top-k equals lax.top_k's order exactly."""
        jq, bq = bqs
        x, q = data
        jd, ji = jbq.hamming_topk(jq.encode(jnp.asarray(q)),
                                  jq.encode(jnp.asarray(x)), 40)
        d, i = pbq.hamming_topk(bq.encode(q), bq.encode(x), 40, chunk=chunk)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))

    def test_search_matches(self, bqs, data):
        jq, bq = bqs
        x, q = data
        jd, ji = jq.search(jq.encode(jnp.asarray(x)), jnp.asarray(q), 10)
        d, i = bq.search(bq.encode(x), q, 10)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))

    def test_own_training(self, data):
        """Blockwise-orthonormal hyperplanes of the JAX shape (bits > d
        takes three blocks), and the data mean as centre."""
        x, _ = data
        bq = pbq.BinaryQuantizer(pbq.BQConfig(bits=64), device="cpu")
        bq.train(x, seed=3)
        h = bq.hyperplanes
        assert h.shape == (64, DIM)
        for lo in (0, 24):
            blk = h[lo:lo + 24]
            torch.testing.assert_close(blk @ blk.T, torch.eye(24),
                                       atol=1e-5, rtol=0)
        np.testing.assert_allclose(bq.mean.numpy(), x.mean(0), atol=1e-5)

    def test_pca_rotation_copy(self, data):
        x, _ = data
        np.testing.assert_array_equal(pbq._pca_rotation(x, 40),
                                      jbq._pca_rotation(x, 40))


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

class TestPlainVersions:
    @pytest.mark.parametrize("n,m,k,length,repeat", [
        (200, 8, 64, 48, False),
        (77, 6, 16, 13, True),     # m not a multiple of the Pallas m_chunk
        (64, 16, 256, 128, True),  # the search block; code 255 present
        (30, 4, 16, 1, False),     # the entry-point call
    ])
    def test_beam_gather_adc(self, n, m, k, length, repeat):
        rng = np.random.RandomState(n + m)
        lut = rng.rand(3, m, k).astype(np.float32)
        codes = rng.randint(0, k, (n, m)).astype(np.uint8)
        codes[::4] = k - 1
        ids = rng.randint(0, n, (3, length)).astype(np.int32)
        if repeat:
            ids[:, ::3] = ids[:, :1]
            ids[:, 1::4] = n - 1
        got = ref.beam_gather_adc_ref(_t(lut), _t(ids), _t(codes)).numpy()
        for i in range(3):
            args = (jnp.asarray(lut[i]), jnp.asarray(ids[i]),
                    jnp.asarray(codes))
            np.testing.assert_allclose(
                got[i], np.asarray(jref.beam_gather_adc_ref(*args)),
                **ADC_TOL)
            np.testing.assert_allclose(
                got[i], np.asarray(beam_gather_adc_kernel(
                    *args, tb=16, m_chunk=4, interpret=True)), **ADC_TOL)

    @pytest.mark.parametrize("n,w,length", [(150, 8, 40), (64, 4, 7),
                                            (20, 1, 20)])
    def test_beam_gather_hamming(self, n, w, length):
        rng = np.random.RandomState(n * w)
        xw, xv = _words(rng, n, w)
        qw, qv = _words(rng, 3, w)
        ids = rng.randint(0, n, (3, length)).astype(np.int32)
        ids[:, ::2] = 0                          # the all-ones row
        got = ref.beam_gather_hamming_ref(_t(qv), _t(ids), _t(xv)).numpy()
        for i in range(3):
            args = (jnp.asarray(qw[i]), jnp.asarray(ids[i]), jnp.asarray(xw))
            np.testing.assert_array_equal(
                got[i], np.asarray(jref.beam_gather_hamming_ref(*args)))
            np.testing.assert_array_equal(
                got[i], np.asarray(beam_gather_hamming_kernel(
                    *args, tb=16, interpret=True)))

    @pytest.mark.parametrize("n,w,length", [(150, 8, 40), (64, 4, 7),
                                            (20, 1, 20), (200, 8, 1)])
    def test_beam_gather_hamming_masked(self, n, w, length):
        """The BQ search step's fused entry: the Hamming distance to the
        clamped id's row where the slot is fresh, +inf where it is not,
        against the JAX kernel (interpret mode) and ``repro``'s plain
        version under the JAX search's own cast and mask.  Ids hold PAD,
        repeats and the all-ones row; query 0 is all fresh, query 1 all
        stale.  Exact, inf slots included."""
        rng = np.random.RandomState(n * w + length)
        nq = 5
        xw, xv = _words(rng, n, w)
        qw, qv = _words(rng, nq, w)
        ids = rng.randint(0, n, (nq, length)).astype(np.int64)
        ids[:, ::2] = 0                          # the all-ones row
        ids[:, 1::3] = ids[:, 1:2]               # repeats
        ids[2:, ::4] = -1                        # PAD
        fresh = rng.rand(nq, length) < 0.6
        fresh[0], fresh[1] = True, False
        fresh[2:, ::4] = False                   # PAD is never fresh
        got = ref.beam_gather_hamming_masked_ref(
            _t(qv), _t(ids), _t(fresh), _t(xv)).numpy()
        assert got.dtype == np.float32
        safe = np.clip(ids, 0, n - 1).astype(np.int32)
        for i in range(nq):
            args = (jnp.asarray(qw[i]), jnp.asarray(safe[i]),
                    jnp.asarray(xw))
            for dist in (jref.beam_gather_hamming_ref(*args),
                         beam_gather_hamming_kernel(*args, tb=16,
                                                    interpret=True)):
                want = jnp.where(jnp.asarray(fresh[i]),
                                 dist.astype(jnp.float32), jnp.inf)
                np.testing.assert_array_equal(got[i], np.asarray(want))
        assert np.isinf(got[1]).all() and np.isfinite(got[0]).all()
        # on CPU tensors ops takes this plain version and launches nothing
        before = (bgh_mod.launches, bgh_mod.masked_launches)
        via_ops = ops.beam_gather_hamming_masked(_t(qv), _t(ids), _t(fresh),
                                                 _t(xv))
        assert torch.equal(via_ops, torch.as_tensor(got))
        assert (bgh_mod.launches, bgh_mod.masked_launches) == before

    @pytest.mark.parametrize("q,n,m,k", [(5, 700, 8, 64), (2, 100, 16, 256),
                                         (9, 333, 6, 16), (1, 64, 32, 256),
                                         (33, 700, 16, 256)])
    def test_pq_adc(self, q, n, m, k):
        rng = np.random.RandomState(q * n)
        lut = rng.rand(q, m, k).astype(np.float32)
        codes = rng.randint(0, k, (n, m)).astype(np.uint8)
        codes[::3] = k - 1
        got = ref.pq_adc_ref(_t(lut), _t(codes)).numpy()
        args = (jnp.asarray(lut), jnp.asarray(codes))
        np.testing.assert_allclose(got, np.asarray(jref.pq_adc_ref(*args)),
                                   **ADC_TOL)
        np.testing.assert_allclose(
            got, np.asarray(pq_adc_kernel(*args, tq=4, tn=256,
                                          interpret=True)), **ADC_TOL)

    @pytest.mark.parametrize("q,n,w", [(5, 700, 8), (33, 129, 4), (2, 50, 16),
                                       (1, 1, 1)])
    def test_hamming(self, q, n, w):
        rng = np.random.RandomState(q + n + w)
        qw, qv = _words(rng, q, w)
        xw, xv = _words(rng, n, w)
        got = ref.hamming_ref(_t(qv), _t(xv)).numpy()
        args = (jnp.asarray(qw), jnp.asarray(xw))
        np.testing.assert_array_equal(got, np.asarray(jref.hamming_ref(*args)))
        np.testing.assert_array_equal(
            got, np.asarray(hamming_kernel(*args, tq=16, tn=128,
                                           interpret=True)))

    def test_popcount_all_bit_patterns(self):
        x = torch.tensor([0, -1, 1, -2 ** 31, 2 ** 31 - 1, 0x0F0F0F0F,
                          -0x55555556], dtype=torch.int32)
        assert ref.popcount32(x).tolist() == [0, 32, 1, 1, 31, 16, 16]

    def test_cpu_tensors_take_the_plain_version(self):
        rng = np.random.RandomState(1)
        lut = _t(rng.rand(2, 4, 16).astype(np.float32))
        codes = _t(rng.randint(0, 16, (30, 4)).astype(np.uint8))
        ids = _t(rng.randint(0, 30, (2, 5)).astype(np.int32))
        _, xv = _words(rng, 30, 2)
        _, qv = _words(rng, 2, 2)
        mods = (bga_mod, bgh_mod, adc_mod, hm_mod)
        before = [m.launches for m in mods]
        assert torch.equal(ops.beam_gather_adc(lut, ids, codes),
                           ref.beam_gather_adc_ref(lut, ids, codes))
        assert torch.equal(ops.beam_gather_hamming(_t(qv), ids, _t(xv)),
                           ref.beam_gather_hamming_ref(_t(qv), ids, _t(xv)))
        assert torch.equal(ops.pq_adc_distances(lut, codes),
                           ref.pq_adc_ref(lut, codes))
        assert torch.equal(ops.hamming_distances(_t(qv), _t(xv)),
                           ref.hamming_ref(_t(qv), _t(xv)))
        assert [m.launches for m in mods] == before   # no launch on the CPU

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        lut = torch.zeros((1, 4, 16))
        codes = torch.zeros((3, 4), dtype=torch.uint8)
        words = torch.zeros((3, 2), dtype=torch.int32)
        ids = torch.zeros((1, 2), dtype=torch.int32)
        for call in (lambda: bga_mod.beam_gather_adc(lut, ids, codes),
                     lambda: bgh_mod.beam_gather_hamming(words[:1], ids,
                                                         words),
                     lambda: bgh_mod.beam_gather_hamming_masked(
                         words[:1], ids.long(), ids.bool(), words),
                     lambda: adc_mod.pq_adc(lut, codes),
                     lambda: hm_mod.hamming(words, words)):
            with pytest.raises(ValueError, match="CUDA tensor"):
                call()


# ---------------------------------------------------------------------------
# code-domain HNSW search on the JAX engine's graph and codes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["pq", "bq"])
def quant_graph(request, data):
    """A JAX engine's sealed graph and codes, and the port's load of them."""
    x, _ = data
    quant = request.param
    jeng = JEngine(JEngineConfig(
        dim=DIM, metric="cosine", builder="bulk", quantization=quant,
        pq=jpq.PQConfig(m=6, k=32, iters=5), bq=jbq.BQConfig(bits=64),
        hnsw=JHNSWConfig(M=8, seed=0, bulk_mode="level")))
    jeng.add(x)
    jeng.build()
    packed = jeng._packed
    pp = PackedHNSW.from_state_dict(packed.state_dict(),
                                    HNSWConfig(M=8, metric=packed.config.metric))
    codes = (pbq.from_uint32(jeng._codes) if quant == "bq"
             else np.asarray(jeng._codes))
    return quant, jeng, to_device(pp, "cpu", codes=codes)


class TestCodeDomainSearch:
    @pytest.mark.parametrize("width", [1, 4])
    def test_matches_jax(self, quant_graph, data, width):
        quant, jeng, (g, ml, _) = quant_graph
        _, q = data
        jg, jml, _ = jeng._device_graph
        assert ml == jml
        if quant == "bq":
            jqc = jeng._bq.encode(jnp.asarray(q))
            proxy = np.asarray(jbq.unpack_bits(jqc, 64), np.float32) * 2 - 1
            qc, metric = _t(pbq.from_uint32(np.asarray(jqc))), "hamming"
        else:
            jqc = jpq.build_adc_lut(jnp.asarray(q), jeng._pq.codebooks,
                                    normalize_inputs=True)
            proxy = preprocess_vectors(q, "cosine")
            qc, metric = _t(jqc), "adc"
        kw = dict(k=10, ef=32, max_level=ml, metric=metric,
                  expansion_width=width, with_iters=True)
        jd, ji, jit = j_search(jg, jnp.asarray(proxy), q_codes=jqc, **kw)
        d, i, it = search(g, _t(proxy), q_codes=qc, **kw)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(it.numpy(), np.asarray(jit))
        if quant == "bq":                  # integer distances: exact
            np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        else:
            np.testing.assert_allclose(d.numpy(), np.asarray(jd), **ADC_TOL)

    @pytest.mark.parametrize("quant_graph", ["bq"], indirect=True)
    def test_hamming_steps_pass_pad_and_stale_slots(self, quant_graph, data,
                                                    monkeypatch):
        """Every layer-0 step of the Hamming search goes through the fused
        entry with the beam's own int64 ids and mask: the entry point's
        call is (Q, 1) and all fresh, and the steps hand it PAD ids and
        stale slots, which come back +inf.  The search still returns the
        JAX search's ids, distances and iteration counts."""
        quant, jeng, (g, ml, _) = quant_graph
        _, q = data
        calls = []

        def spy(qc, ids, fresh, codes, **kw):
            out = ops_masked(qc, ids, fresh, codes, **kw)
            calls.append((ids.clone(), fresh.clone(), out))
            return out

        ops_masked = ops.beam_gather_hamming_masked
        monkeypatch.setattr(ops, "beam_gather_hamming_masked", spy)
        jg, _, _ = jeng._device_graph
        jqc = jeng._bq.encode(jnp.asarray(q))
        proxy = np.asarray(jbq.unpack_bits(jqc, 64), np.float32) * 2 - 1
        kw = dict(k=10, ef=32, max_level=ml, metric="hamming",
                  expansion_width=4, with_iters=True)
        jd, ji, jit = j_search(jg, jnp.asarray(proxy), q_codes=jqc, **kw)
        d, i, it = search(g, _t(proxy), q_codes=_t(pbq.from_uint32(
            np.asarray(jqc))), **kw)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(it.numpy(), np.asarray(jit))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        ids0, fresh0, _ = calls[0]
        assert ids0.shape == (len(q), 1) and bool(fresh0.all())
        assert len(calls) == 1 + int(it.max())     # one call a step
        steps = calls[1:]
        assert all(c[0].dtype == torch.int64 and c[1].dtype == torch.bool
                   for c in steps)
        assert any(bool((c[0] == -1).any()) for c in steps)
        assert any(bool((~c[1] & (c[0] >= 0)).any()) for c in steps)
        for ids, fresh, out in steps:
            assert torch.equal(torch.isinf(out), ~fresh)

    def test_needs_codes(self, quant_graph, data):
        _, _, (g, ml, _) = quant_graph
        with pytest.raises(ValueError, match="needs g.codes"):
            search(g._replace(codes=None), _t(data[1]), k=5, ef=8,
                   max_level=ml, metric="hamming",
                   q_codes=torch.zeros((20, 2), dtype=torch.int32))
