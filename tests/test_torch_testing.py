"""``tensorflowasr_tpu_torch/testing.py``: the training batches and
trainers that the tests and ``chip_smoke.py`` build on, their shapes,
ranges and seeds, and the full-width shipped configs they read."""

import numpy as np
import pytest
import torch

from tensorflowasr_tpu_torch import testing as synth

torch.set_num_threads(2)


def test_bench_batch_is_the_training_benchmark_batch():
    """Shapes, ranges and seed of the offline training batch, and the
    full-width model the shipped configs give."""
    from tensorflowasr_tpu_torch.models.conformer import ConformerConfig

    batch = synth.train_batch(b=3, seconds=1.0, n_phones=6, n_chars=4)
    assert batch["wav"].shape == (3, 16000)
    assert batch["wav"].dtype == np.float32
    assert batch["input_length"].tolist() == [25] * 3
    assert batch["phone_length"].tolist() == [6] * 3
    assert batch["phones"].min() >= 1
    assert batch["phones"].max() < synth.N_PHONE - 1     # never the blank
    assert 1 <= batch["chars"].min() and batch["chars"].max() < synth.N_CHAR
    again = synth.train_batch(b=3, seconds=1.0, n_phones=6, n_chars=4)
    assert all(np.array_equal(batch[k], again[k]) for k in batch)
    assert (synth.TRAIN_B, synth.TRAIN_SECONDS, synth.TRAIN_PHONES,
            synth.TRAIN_CHARS) == (128, 8, 64, 32)
    cfg = ConformerConfig.from_user_config(synth.shipped_config(), "float32")
    assert (cfg.dmodel, cfg.num_blocks, cfg.num_heads, cfg.head_size,
            cfg.kernel_size, cfg.dropout) == (144, 13, 4, 36, 32, 0.1)
    off = synth.shipped_config(extra={"model_config": {"dropout": 0.0}})
    assert ConformerConfig.from_user_config(off, "float32").dropout == 0.0


def test_chunk_bench_batch_and_trainer():
    """The chunk model's training batch and trainer: shapes, ranges, the
    seed, the full-width shipped config, and a calibration that picks part
    of the frames in training mode."""
    VP, VC = synth.N_PHONE, synth.N_CHAR
    batch = synth.chunk_train_batch(b=2, seconds=0.64, n_phones=6,
                                    n_chars=4, n_extra_phones=5,
                                    n_extra_chars=3)
    assert batch["wav"].shape == (2, 10240)
    assert batch["input_length"].tolist() == [16, 16]
    assert [batch[k].shape[1] for k in ("phones", "chars", "extra_phones",
                                        "extra_chars")] == [6, 4, 5, 3]
    for key, top in (("phones", VP - 1), ("extra_phones", VP - 1),
                     ("chars", VC - 1), ("extra_chars", VC - 1)):
        assert 1 <= batch[key].min() and batch[key].max() < top, key
        assert (batch[key[:-1] + "_length"] == batch[key].shape[1]).all()
    again = synth.chunk_train_batch(b=2, seconds=0.64, n_phones=6,
                                    n_chars=4, n_extra_phones=5,
                                    n_extra_chars=3)
    assert all(np.array_equal(batch[k], again[k]) for k in batch)
    with pytest.raises(ValueError, match="whole"):
        synth.chunk_train_batch(b=1, seconds=1.0)
    trainer = synth.new_chunk_trainer("float32", "cpu")
    cfg = trainer.model_cfg
    assert (cfg.dmodel, cfg.encoder.num_blocks, cfg.decoder.win_back,
            trainer.max_pick, trainer.txt_ctc_length,
            trainer.loss_reduction) == (144, 15, 8, None, "padded", "sum")
    # calibrated in training mode on the batch's first rows, without
    # moving the BatchNorm running statistics
    model = trainer.state.model
    assert not any(float(v.abs().max())
                   for k, v in model.state_dict().items()
                   if k.endswith("running_mean"))
    with torch.no_grad():
        logits, _ = model.train().encode_to_phones(torch.from_numpy(
            synth.bench_wav(synth.CALIBRATION_ROWS, synth.TRAIN_SECONDS)))
    share = float((logits.argmax(-1) != VP - 1).float().mean())
    assert 0.4 <= share <= 0.6, share
