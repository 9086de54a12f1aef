"""The traffic generator: the same seed gives the same inputs, every seed
the same set of sizes, and the mixes' stated distributions."""

import numpy as np
import pytest

import tiny  # noqa: F401  (puts the benchmark on the path)
from benchlib import core, traffic

SIZES = dict(hop=160, reduction_factor=4, num_phone_classes=231,
             num_char_classes=9161, char_end_id=2)
SEEDS = (0, 2 ** 31 + 12345, 2 ** 63 - 1)


def mix(name):
    return core.cell_files(name).traffic


def small_batches(seed, n=8):
    m = dict(mix("conformer_s.train"), distinct_batches=n, batch_size=4)
    return traffic.batches(m, SIZES, seed)


def test_batches_repeat_for_a_seed():
    a, b = small_batches(SEEDS[1]), small_batches(SEEDS[1])
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_tones_rendered_together_are_the_tones_alone():
    """Rows rendered in one pass are the samples ``tones`` gives for each
    row's draws, zero past their lengths; and those are gated tones."""
    rng = traffic.rng_for(5, 1)
    lengths = np.array([800, 1234, 4000])
    params = [traffic.tone_params(int(n), rng) for n in lengths]
    got = traffic.render(params, lengths, 4480).numpy()
    rng = traffic.rng_for(5, 1)
    for row, n in zip(got, lengths):
        want = traffic.tones(int(n), rng)
        np.testing.assert_array_equal(row[:n], want)
        assert not row[n:].any()
    f, level = params[2]
    t = np.arange(800) / traffic.SR + 0.05
    seg = 0.3 * level[1] * (np.sin(2 * np.pi * f[1, 0] * t)
                            + np.sin(2 * np.pi * f[1, 1] * t))
    np.testing.assert_allclose(got[2, 800:1600], seg, atol=1e-6)


def test_seeds_share_the_sizes_not_the_inputs():
    a, b = small_batches(SEEDS[0]), small_batches(SEEDS[1])
    key = lambda bl: sorted((float(x["bucket_s"]), *np.sort(x["seconds"]))
                            for x in bl)
    assert np.allclose(np.sort(np.concatenate([x["seconds"] for x in a])),
                       np.sort(np.concatenate([x["seconds"] for x in b])))
    assert sorted(x["bucket_s"] for x in a) == sorted(x["bucket_s"]
                                                      for x in b)
    assert key(a) != key(b) or not np.array_equal(a[0]["wav"], b[0]["wav"])


def test_bucket_shares_of_the_shipped_mix():
    """Log-normal, median 4.2 s, sigma 0.35, clipped to 1-16 s: about 44 %
    of batches at 4 s, 52 % at 8 s, 3 % at 12 s (AMDataLoader's buckets)."""
    m = mix("conformer_s.train")
    law = traffic.Durations(m["duration_s"])
    plan = traffic.bucket_plan(law, m["buckets_s"], m["distinct_batches"])
    shares = [p["share"] for p in plan]
    assert shares[0] == pytest.approx(0.445, abs=0.01)
    assert shares[1] == pytest.approx(0.522, abs=0.01)
    assert shares[2] == pytest.approx(0.031, abs=0.005)
    assert sum(p["batches"] for p in plan) == m["distinct_batches"]
    assert 4.4 < law.mean() < 4.6


@pytest.mark.parametrize("seed", SEEDS)
def test_batches_pad_to_their_bucket(seed):
    for b in small_batches(seed):
        cap = b["bucket_s"]
        assert b["wav"].dtype == np.int16
        assert b["wav"].shape == (4, int(cap * 16000))
        assert np.all(b["seconds"] <= cap) and np.all(b["seconds"] >= 1.0)
        assert np.all(b["input_length"] == (b["seconds"] * 16000).round()
                      .astype(int) // 640)
        ends = b["chars"][np.arange(4), b["char_length"] - 1]
        assert np.all(ends == SIZES["char_end_id"])
        assert np.all(b["phones"][:, :1] < 230)       # never the blank


def test_durations_are_clipped():
    law = traffic.Durations({"median": 4.2, "sigma": 0.35, "min": 2.0,
                             "max": 10.0})
    d = law.stratified(4096)
    assert d.min() >= 2.0 and d.max() <= 10.0
    assert np.median(d) == pytest.approx(4.2, rel=0.01)


def test_warm_order_leads_with_every_bucket():
    bl = traffic.warm_order(small_batches(7, n=16), 3)
    buckets = {b["bucket_s"] for b in bl}
    assert {b["bucket_s"] for b in bl[:len(buckets)]} == buckets


def test_lane_phases_spread_over_a_chunk():
    m = dict(mix("chunk_conformer_s.streams"), distinct_utterances=16)
    a = traffic.lanes(m, SEEDS[1], 40, 2560, 12.0)
    b = traffic.lanes(m, SEEDS[1], 40, 2560, 12.0)
    phase = np.sort(a["phase_s"])
    assert np.allclose(phase, (np.arange(40) + 0.5) / 40 * 0.16)
    assert a["lanes"] == b["lanes"]
    for wav in a["pool"]:
        assert len(wav) % 2560 == 0 and 2.0 <= len(wav) / 16000 < 10.2
    for items in a["lanes"]:
        starts = [t for t, _ in items]
        assert starts == sorted(starts) and starts[-1] < 12.0


def test_files_are_deterministic():
    m = dict(mix("conformer_s.requests"), distinct_files=5)
    for x, y in zip(traffic.files(m, 11), traffic.files(m, 11)):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(traffic.files(m, 11)[0],
                              traffic.files(m, 12)[0])
