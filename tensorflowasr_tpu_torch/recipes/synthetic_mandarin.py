"""Generate a synthetic Mandarin corpus in the AISHELL-1 layout.

Counterpart of ``examples/synthetic_mandarin/generate.py``: the same flags,
the same seeded numpy draws in the same order and the same scipy calls, so
the same arguments write the same files byte for byte (wavs, the
transcript, ``lexicon.tsv``, the noise wavs; ``noise.list`` holds absolute
paths, so only its root differs between two output directories).

Hanzi transcripts over hundreds of characters whose pinyin covers the full
initial / final phone inventory (``utils/phones.py``'s rule table), rendered
to audio by a deterministic phone synthesizer (each phone a unique two-tone
chord with a tone contour on finals). Then the standard recipe runs:

  python -m tensorflowasr_tpu_torch.recipes.synthetic_mandarin \\
      --out_dir /tmp/synth
  python -m tensorflowasr_tpu_torch.recipes.aishell1_prepare \\
      --data_dir /tmp/synth --out_dir /tmp/synth_work \\
      --train_time_lexicon /tmp/synth/lexicon.tsv
  python -m tensorflowasr_tpu_torch.cli.train_asr \\
      --data_config /tmp/synth_work/am_data.yml \\
      --model_config configs/conformerS.yml --total_steps 3000
  python -m tensorflowasr_tpu_torch.cli.eval_am \\
      --data_config /tmp/synth_work/am_data.yml \\
      --model_config configs/conformerS.yml

Text has bigram structure (a seeded Markov chain over characters), so
``eval_am --lm`` shallow fusion is demonstrable on this corpus too.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from tensorflowasr_tpu_torch.utils.audio import write_wav
from tensorflowasr_tpu_torch.utils.phones import build_pinyin2phone

SR = 16000
PHONE_SECONDS = 0.09


def _phone_freqs(phones):
    """phone -> (f1, f2) base code; unique two-tone chord per phone."""
    return {ph: (220.0 + 31.0 * (i % 40), 1480.0 + 53.0 * (i // 40))
            for i, ph in enumerate(sorted(phones))}


def synth_phone(ph, f1, f2, n, weights=(0.55, 0.3, 0.0)):
    """Render one phone: tone contour on f1, chord at (f1, f2), optional
    third harmonic at 2*f1 (speaker timbre)."""
    t = np.arange(n) / SR
    dur = n / SR
    env = np.hanning(2 * n)[:n]          # attack-only half window
    tone = ph[-1] if ph[-1].isdigit() else None
    if tone == "2":
        f1_t = f1 * (1.0 + 0.12 * t / dur)
    elif tone == "3":
        f1_t = f1 * (1.0 - 0.12 * np.sin(np.pi * t / dur))
    elif tone == "4":
        f1_t = f1 * (1.0 - 0.12 * t / dur)
    else:
        f1_t = np.full_like(t, f1)
    phase = 2 * np.pi * np.cumsum(f1_t) / SR
    w1, w2, w3 = weights
    wav = (w1 * np.sin(phase) + w2 * np.sin(2 * np.pi * f2 * t)
           + w3 * np.sin(2 * phase))
    return (wav * env).astype(np.float32)


def phone_bank(phones):
    """phone -> [n] float32 waveform at the canonical timbre/rate (the
    legacy single-speaker corpus; also used for babble noise)."""
    n = int(SR * PHONE_SECONDS)
    return {ph: synth_phone(ph, f1, f2, n)
            for ph, (f1, f2) in _phone_freqs(phones).items()}


class Speaker:
    """A speaker timbre: formant-code scaling (phone codes from nearby
    slots genuinely overlap across speakers — the model must normalize
    from utterance context), harmonic mix, and base speaking rate."""

    def __init__(self, rng):
        self.f1_scale = float(rng.uniform(0.95, 1.05))
        self.f2_scale = float(rng.uniform(0.96, 1.04))
        self.weights = (float(rng.uniform(0.4, 0.65)),
                        float(rng.uniform(0.2, 0.4)),
                        float(rng.uniform(0.0, 0.25)))
        self.rate = float(rng.uniform(0.85, 1.2))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--n_chars", type=int, default=250)
    p.add_argument("--n_train", type=int, default=1500)
    p.add_argument("--n_dev", type=int, default=150)
    p.add_argument("--n_test", type=int, default=100)
    p.add_argument("--min_len", type=int, default=4)
    p.add_argument("--max_len", type=int, default=12)
    p.add_argument("--noise", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=0)
    # -- hardness knobs (defaults keep the legacy easy corpus) ---------
    p.add_argument("--speakers", type=int, default=0,
                   help="multi-speaker timbre variation: N speakers with "
                        "individual formant scaling / harmonic mix / "
                        "speaking rate; the last max(2, N//6) speakers "
                        "are HELD OUT for the test split (0 = legacy "
                        "single canonical timbre)")
    p.add_argument("--rate_var", default="1,1",
                   help="per-utterance speaking-rate multiplier range "
                        "LO,HI on top of the speaker's base rate "
                        "(e.g. 0.85,1.25)")
    p.add_argument("--reverb", type=float, default=0.0,
                   help="probability of convolving an utterance with a "
                        "synthetic exponential-decay room impulse")
    p.add_argument("--noise_min", type=float, default=None,
                   help="per-utterance additive-noise amplitude drawn "
                        "U(noise_min, --noise); default: fixed --noise")
    p.add_argument("--emit_noise", type=int, default=0,
                   help="write N noise wavs (colored noise + phone "
                        "babble) and a noise.list for the SignalNoise "
                        "augmenter on both frameworks")
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    p2p = build_pinyin2phone()                    # full rule table
    pinyins = sorted(p2p)
    rng.shuffle(pinyins)
    chars = [chr(0x4E00 + i) for i in range(args.n_chars)]
    lexicon = {c: pinyins[i % len(pinyins)] for i, c in enumerate(chars)}
    phones = sorted({ph for c in chars for ph in p2p[lexicon[c]]})
    bank = phone_bank({ph for py in p2p for ph in p2p[py]})
    print(f"{len(chars)} chars, {len(phones)} distinct phones in corpus")

    # bigram language: each char prefers a few successors (so an n-gram
    # LM genuinely helps decoding)
    succ = {c: rng.choice(chars, size=4, replace=False) for c in chars}

    def sample_text():
        length = int(rng.integers(args.min_len, args.max_len + 1))
        out = [chars[int(rng.integers(len(chars)))]]
        for _ in range(length - 1):
            if rng.random() < 0.8:
                out.append(str(rng.choice(succ[out[-1]])))
            else:
                out.append(chars[int(rng.integers(len(chars)))])
        return "".join(out)

    rate_lo, rate_hi = (float(x) for x in args.rate_var.split(","))
    freqs = _phone_freqs({ph for py in p2p for ph in p2p[py]})
    speakers = [Speaker(rng) for _ in range(args.speakers)]
    # held-out test speakers: want >= 2 of them but always leave at
    # least 1 training speaker (--speakers 1 holds out none)
    n_held_out = (min(args.speakers - 1, max(2, args.speakers // 6))
                  if args.speakers >= 2 else 0)

    def render(text, spk: "Speaker | None"):
        segs = [np.zeros(int(SR * rng.uniform(0.05, 0.15)), np.float32)]
        utt_rate = rng.uniform(rate_lo, rate_hi)
        pitch = rng.uniform(0.98, 1.02) if spk else 1.0
        for ch in text:
            for ph in p2p[lexicon[ch]]:
                if spk is None:
                    segs.append(bank[ph])
                else:
                    f1, f2 = freqs[ph]
                    dur = (PHONE_SECONDS * spk.rate * utt_rate
                           * rng.uniform(0.92, 1.08))
                    segs.append(synth_phone(
                        ph, f1 * spk.f1_scale * pitch,
                        f2 * spk.f2_scale * pitch,
                        int(SR * dur), spk.weights))
            segs.append(np.zeros(int(SR * 0.02 * utt_rate), np.float32))
        segs.append(np.zeros(int(SR * rng.uniform(0.05, 0.1)), np.float32))
        wav = np.concatenate(segs)
        if args.reverb > 0 and rng.random() < args.reverb:
            from scipy.signal import fftconvolve
            tau = rng.uniform(0.02, 0.08)
            ir_t = np.arange(int(SR * 0.15)) / SR
            ir = (np.exp(-ir_t / tau)
                  * rng.standard_normal(len(ir_t))).astype(np.float32)
            ir[0] = 1.0
            ir /= np.sqrt(np.sum(ir ** 2))
            wav = fftconvolve(wav, ir)[:len(wav)].astype(np.float32)
        wav = wav * rng.uniform(0.5, 0.95)
        amp = (rng.uniform(args.noise_min, args.noise)
               if args.noise_min is not None else args.noise)
        wav += amp * rng.standard_normal(len(wav)).astype(np.float32)
        return wav.astype(np.float32)

    os.makedirs(os.path.join(args.out_dir, "transcript"), exist_ok=True)
    trans = []
    counts = {"train": args.n_train, "dev": args.n_dev, "test": args.n_test}
    for split, n in counts.items():
        for i in range(n):
            if speakers:
                # test split: held-out speakers only (speaker-independent
                # evaluation, like AISHELL's disjoint test speakers);
                # with n_held_out == 0 every split shares the pool
                if split == "test" and n_held_out:
                    sid = len(speakers) - 1 - int(
                        rng.integers(n_held_out))
                else:
                    sid = int(rng.integers(len(speakers) - n_held_out))
                spk = speakers[sid]
            else:
                sid, spk = i % 20, None
            spk_name = f"S{sid:04d}"
            utt = f"BAC{split[:2].upper()}{i:06d}W"
            d = os.path.join(args.out_dir, "wav", split, spk_name)
            os.makedirs(d, exist_ok=True)
            text = sample_text()
            write_wav(os.path.join(d, utt + ".wav"), render(text, spk), SR)
            trans.append(f"{utt} {' '.join(text)}")
        print(f"{split}: {n} utts")

    if args.emit_noise:
        nd = os.path.join(args.out_dir, "noise")
        os.makedirs(nd, exist_ok=True)
        paths = []
        for i in range(args.emit_noise):
            n = SR * 10
            if i % 2 == 0:          # colored noise (one-pole lowpass)
                from scipy.signal import lfilter
                x = rng.standard_normal(n).astype(np.float32)
                a = rng.uniform(0.6, 0.95)
                y = lfilter([1 - a], [1, -a], x).astype(np.float32)
                wav = y / (np.abs(y).max() + 1e-6) * 0.5
            else:                   # phone babble
                segs = []
                keys = sorted(bank)
                while sum(len(s) for s in segs) < n:
                    segs.append(bank[keys[int(rng.integers(len(keys)))]])
                wav = np.concatenate(segs)[:n] * 0.5
            path = os.path.join(nd, f"noise{i:03d}.wav")
            write_wav(path, wav.astype(np.float32), SR)
            paths.append(os.path.abspath(path))
        with open(os.path.join(args.out_dir, "noise.list"), "w") as f:
            f.write("\n".join(paths) + "\n")
        print(f"noise: {args.emit_noise} wavs + noise.list")
    with open(os.path.join(args.out_dir, "transcript",
                           "aishell_transcript_v0.8.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(trans) + "\n")
    with open(os.path.join(args.out_dir, "lexicon.tsv"), "w",
              encoding="utf-8") as f:
        for c in chars:
            f.write(f"{c}\t{lexicon[c]}\n")
    print(f"corpus -> {args.out_dir} (lexicon.tsv for "
          f"aishell1_prepare --train_time_lexicon)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
