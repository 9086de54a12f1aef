"""The ``ebranchformer_l.decode`` cell at a size the CPU holds, through the
harness (set-up, window, judge): a sound run is correct and a token
altered where it is produced is not; the FLOP count against a hand count
of one block; the reference's names are the program's."""

import copy

import pytest
import torch

import tiny  # noqa: F401  (the harness on the path)
from benchlib import core, ebranchformer_flops, flops, program
from reference import blocks
from reference import ebranchformer as ref

CELL = "ebranchformer_l.decode"


def small_files():
    """The cell's files at small widths and depth (f32 compute, so that the
    program and the reference agree to rounding) and small traffic."""
    files = copy.deepcopy(core.cell_files(CELL))
    c = files.config
    c["dtype"] = "float32"
    c["num_phone_classes"], c["num_char_classes"] = 11, 17
    c["model_config"].update(
        dmodel=16, num_blocks=2, num_heads=2, head_size=8, linear_units=24,
        cgmlp_linear_units=40, cgmlp_conv_kernel=5, merge_conv_kernel=5,
        kernel_size=4, ctcdecoder_kernel_size=4, translator_num_blocks=1,
        translator_kernel_size=4)
    files.traffic.update(
        batch_size=4, distinct_batches=4, buckets_s=[1, 2], judged_batches=2,
        duration_s={"dist": "lognormal", "median": 0.8, "sigma": 0.35,
                    "min": 0.3, "max": 2.0})
    return files


def run(fault=None):
    torch.manual_seed(0)
    return core.run_cell(small_files(), 2 ** 31 + 11, 1.0, False,
                         torch.device("cpu"), fault=fault)


def test_sound_run_is_correct():
    res = run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["end_to_end"]) == {"decode_audio_s_per_s"}


def test_an_altered_token_is_not_correct():
    res = run(fault="alter_token")
    assert not res["correct"], res["checks"]


def test_the_control_reads_above_the_program():
    res = run()
    got = res["runner"].control(blocks.Prec("fp8", "fp8"))
    checks = res["checks"]
    assert any(got[k] > checks[k]["value"] for k in got), (got, checks)


def test_one_block_by_hand():
    # b = 1, t = 3, d = 2, U = 4, C = 4, kernels 3: FFNs 2 x (2*3*2*4 +
    # 2*3*4*2) = 192; attention: q, k, v, out 4 x 2*3*2*2 = 96, positions
    # 2*5*2*2 = 40 (once a batch), content 2*3*3*2 = 36, position scores
    # 2*3*5*2 = 60, weighted values 36; cgMLP 2*3*2*4 + 2*3*2*3 + 2*3*2*2
    # = 108; merge 2*3*4*3 + 2*3*4*2 = 120
    m = dict(dmodel=2, linear_units=4, cgmlp_linear_units=4,
             cgmlp_conv_kernel=3, merge_conv_kernel=3)
    assert ebranchformer_flops.block(1, 3, m) == \
        192 + 96 + 40 + 36 + 60 + 36 + 108 + 120
    # the positions' projection is the batch's, the rest each row's
    assert ebranchformer_flops.block(2, 3, m) == \
        2 * ebranchformer_flops.block(1, 3, m) - 40


def test_the_published_cell_counts():
    """At the cell's size the blocks are ~60 % of a 12 s batch's model
    FLOPs and the conv front ~25 %, about 400 MFLOP an encoder frame."""
    m = program.reference_sizes(core.cell_files(CELL).config)
    b, samples = 32, 12 * 16000
    t = ebranchformer_flops.frames(samples, m)
    total = ebranchformer_flops.predict(b, samples, m, 231, 9161)
    blocks_ = m["num_blocks"] * ebranchformer_flops.block(b, t, m)
    front = ebranchformer_flops.front(b, samples, m)
    assert t == 300
    assert 0.55 < blocks_ / total < 0.65
    assert 0.2 < front / total < 0.3
    assert 3.5e8 < total / (b * t) < 4.5e8
    assert total == ebranchformer_flops.encoder(b, samples, m) \
        + flops.ctc_head(b, t, m, 231) + flops.translator(b, t + 10, t, m,
                                                          9161)


def test_the_reference_names_are_the_programs():
    from tensorflowasr_tpu_torch.models.ebranchformer import (
        EBranchformerConfig,
        EBranchformerCTC,
    )
    files = small_files()
    c = copy.deepcopy(files.config)
    m = program.reference_sizes(c)
    cfg = EBranchformerConfig.from_user_config(
        {"model_config": c["model_config"],
         "speech_config": c["speech_config"]}, "float32")
    model = EBranchformerCTC(cfg, c["num_phone_classes"],
                             c["num_char_classes"])
    spec = ref.param_spec(m, c["num_phone_classes"], c["num_char_classes"])
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(s) for k, (s, _) in spec.items()}


@pytest.mark.parametrize("metric", [
    "ebf.stack_device_ms", "ebf.attention_device_ms", "ebf.cgmlp_device_ms",
    "ebf.merge_device_ms", "ebf.launches_per_batch", "mfu.decode_ebf",
    "device_idle.decode_ebf"])
def test_the_readers_find_nothing_without_a_trace(metric):
    files = small_files()
    res = run()
    files.per_layer = [m for m in files.per_layer if m["name"] == metric]
    assert files.per_layer
    assert core.per_layer(files, res, "cpu") == {}


class _Event:
    """A raw profiler event as ``branch_device_s`` reads it."""

    def __init__(self, name, start, end, device=False, thread=1, corr=0,
                 link=0, annotation=False):
        self._v = (name, start, end, device, thread, corr, link, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        cuda = torch.autograd.DeviceType.CUDA
        return cuda if self._v[3] else torch.autograd.DeviceType.CPU

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[7]


def test_branch_device_time_is_read_from_the_launches_inside_each_range():
    import types

    from runners import decode_ebf
    events = [
        _Event("tasr.ebranchformer.attention", 100, 200),
        _Event("tasr.ebranchformer.cgmlp", 300, 400),
        _Event("cudaLaunchKernel", 110, 120, corr=1),    # in attention
        _Event("cudaLaunchKernel", 150, 160, corr=2),    # in attention
        _Event("cudaLaunchKernel", 250, 260, corr=3),    # between ranges
        _Event("cudaLaunchKernel", 310, 320, corr=4),    # in cgmlp
        _Event("cudaLaunchKernel", 120, 130, thread=2, corr=5),  # other thread
        _Event("gemm", 1000, 1500, device=True, link=1),
        _Event("softmax", 2000, 2300, device=True, link=2),
        _Event("add", 3000, 3700, device=True, link=3),
        _Event("gelu", 4000, 4011, device=True, link=4),
        _Event("copy", 5000, 6000, device=True, link=5),
        _Event("tasr.ebranchformer.cgmlp", 4000, 9000, device=True, link=4,
               annotation=True),
    ]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    got = decode_ebf.branch_device_s(prof)
    assert got == {"ebranchformer.attention": 800e-9,
                   "ebranchformer.cgmlp": 11e-9,
                   "ebranchformer.merge": 0.0}
