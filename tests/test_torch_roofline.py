"""The port's roofline arithmetic against the reference's, and the
attention-pair count K5/K6's bounds and the dry run read, against a
brute-force count of the mask."""
import numpy as np
import pytest

from repro.launch import roofline as ref
from repro_torch.launch import roofline as rl


@pytest.mark.parametrize("total,active,tokens,train", [
    (1_720_000_000, None, 4096 * 256, True),
    (1_334_756_352, 400_000_000, 32_768 * 32, False),
    (19_869_020_160, 0, 128, False),
    (12, 7, 3, True)])
def test_model_flops_equal_reference(total, active, tokens, train):
    assert rl.model_flops(None, total, active, tokens, train=train) == \
        ref.model_flops(None, total, active, tokens, train=train)


@pytest.mark.parametrize("v_a,v_b,n,a", [(1.5e12, 2.25e12, 24, 2),
                                         (10.0, 7.0, 3, 1),
                                         (0.0, 3.3e9, 48, 2)])
def test_extrapolate_layers_equal_reference(v_a, v_b, n, a):
    assert rl.extrapolate_layers(v_a, v_b, n, a) == \
        ref.extrapolate_layers(v_a, v_b, n, a)


@pytest.mark.parametrize("flops,nbytes,coll,chips", [
    (3.5e13, 5.0e11, 0.0, 1),         # compute-bound
    (1.4e12, 1.9e13, 2.0e9, 1),       # memory-bound
    (1e9, 1e9, 4e12, 4)])             # collective-bound
def test_roofline_terms_equal_reference_on_its_constants(
        monkeypatch, flops, nbytes, coll, chips):
    """Fed the TPU v5e's figures, the port's terms are the reference's."""
    monkeypatch.setitem(rl.PEAK_FLOPS, "bfloat16", ref.PEAK_FLOPS)
    monkeypatch.setattr(rl, "HBM_BW", ref.HBM_BW)
    monkeypatch.setattr(rl, "NVLINK_BW", ref.ICI_BW)
    got = rl.roofline_terms(hlo_flops=flops, hlo_bytes=nbytes,
                            coll_bytes=coll, chips=chips, dtype="bfloat16")
    assert got == ref.roofline_terms(hlo_flops=flops, hlo_bytes=nbytes,
                                     coll_bytes=coll, chips=chips)


def test_h100_figures_pick_the_peak_by_dtype():
    t = rl.roofline_terms(hlo_flops=67e12, hlo_bytes=3.35e12,
                          coll_bytes=450e9)
    assert t["compute_s"] == 1.0 and t["memory_s"] == 1.0 and \
        t["collective_s"] == 1.0
    bf = rl.roofline_terms(hlo_flops=989.4e12, hlo_bytes=0, coll_bytes=0,
                           dtype="bfloat16")
    assert bf["compute_s"] == 1.0 and bf["dominant"] == "compute"
    assert rl.PEAK_FLOPS["tfloat32"] == 494.7e12 and rl.HBM_BYTES == 80e9


def _brute(sq, sk, causal, window, kv_len):
    i = np.arange(sq)[:, None]
    j = np.arange(sk)[None, :]
    m = np.broadcast_to(j < (sk if kv_len is None else kv_len), (sq, sk))
    if causal:
        m = m & (j <= i)
    if window > 0:
        m = m & (j > i - window)
    return int(m.sum())


@pytest.mark.parametrize("sq,sk,causal,window,kv_len", [
    (2048, 2048, True, 0, None), (2048, 2048, True, 1024, None),
    (4096, 4096, True, 1024, None), (1536, 1536, False, 0, None),
    (333, 333, True, 0, None), (1000, 1000, True, 1024, None),
    (384, 384, False, 0, 300), (256, 1536, False, 0, 1500),
    (640, 640, True, 1024, 545), (129, 77, True, 16, None)])
def test_allowed_pairs_equal_brute_force_mask(sq, sk, causal, window,
                                              kv_len):
    assert rl.allowed_pairs(sq, sk, causal, window, kv_len) == \
        _brute(sq, sk, causal, window, kv_len)


def test_attention_work_counts_pairs_and_each_tensor_once():
    b, s, h, hkv, hd = 2, 512, 16, 8, 128
    w = rl.attention_work(b, s, s, h, hkv, hd, True, 0)
    pairs = b * h * s * (s + 1) // 2
    assert w["fwd"][0] == 4 * hd * pairs and w["bwd"][0] == 10 * hd * pairs
    q_n, k_n = b * s * h * hd, b * s * hkv * hd
    assert w["fwd"][1] == 4 * (2 * q_n + 2 * k_n) + 4 * b * h * s
    assert w["bwd"][1] == 4 * (4 * q_n + 4 * k_n) + 8 * b * h * s
    assert rl.attention_work(b, s, s, h, hkv, hd, True, 0, esz=2)["fwd"][1] \
        == 2 * (2 * q_n + 2 * k_n) + 4 * b * h * s
