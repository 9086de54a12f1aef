"""Train / evaluate the shallow-fusion n-gram LM from data lists.

    python -m tensorflowasr_tpu_torch.cli.train_lm \\
        --data_config am_data.yml [--model_config conformerS.yml] \\
        --unit phone --order 3 --output lm_phone3.npz \\
        [--lists L.list ...] [--eval_lists held_out.list] \\
        [--lm LM.npz|LM.arpa] [--arpa_out LM.arpa] [--discount 0.75]

Counterpart of ``tensorflowasr_tpu/cli/train_lm.py``, host-only: reads the
same ``wav\ttranscript`` lists the AM trainers use, featurizes transcripts
to phone or char ids, estimates an interpolated Kneser-Ney backoff LM (order
2-4) and saves it as the flat-tensor .npz that
``ops.beam.ctc_beam_search_decode(ngram_lm=lm_pack(lm, device))`` scores on
the device. The .npz holds the JAX CLI's arrays element for element, and
the ARPA text is its byte for byte.
"""

from __future__ import annotations

import sys
from typing import List, Sequence

from tensorflowasr_tpu_torch.cli.common import (
    build_featurizers,
    config_parser,
    load_config,
)


def _lines(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        with open(p, encoding="utf-8") as f:
            out.extend(line.strip() for line in f if line.strip())
    return out


def _to_ids(lines: Sequence[str], unit: str, phone_f, char_f, p2p, pin,
            transcripts_are_pinyin: bool) -> List[List[int]]:
    from tensorflowasr_tpu_torch.utils.text import (
        only_chinese,
        tokens_to_phones,
    )

    seqs: List[List[int]] = []
    for line in lines:
        txt = line.split("\t", 1)[1] if "\t" in line else line
        if not transcripts_are_pinyin:
            txt = only_chinese(txt)
        if unit == "phone":
            if transcripts_are_pinyin:
                pins = txt.split()
            elif pin is not None and pin.available:
                pins = pin.convert(txt)
            else:
                continue
            toks = tokens_to_phones(pins, p2p, phone_f) if p2p else pins
            if not all(phone_f.has(t) for t in toks):
                continue
            seqs.append(phone_f.extract(toks))
        else:
            chars = txt.split() if transcripts_are_pinyin else list(txt)
            if not all(char_f.has(c) for c in chars):
                continue
            seqs.append(char_f.extract(chars))
    return seqs


def main(argv=None):
    p = config_parser("train an n-gram LM from transcript lists",
                      model_required=False, device=False)
    p.add_argument("--lists", nargs="+", default=None,
                   help="data lists (wav\\ttext); default: train_list "
                        "from the data config")
    p.add_argument("--eval_lists", nargs="+", default=None,
                   help="held-out lists: report perplexity only "
                        "(requires --lm or trains first)")
    p.add_argument("--unit", choices=["phone", "char"], default="phone")
    p.add_argument("--order", type=int, default=3)
    p.add_argument("--discount", type=float, default=0.75)
    p.add_argument("--output", default="lm.npz")
    p.add_argument("--lm", default=None,
                   help="existing lm.npz (or .arpa: KenLM text import): "
                        "skip training, evaluate only")
    p.add_argument("--arpa_out", default=None,
                   help="also export the LM as ARPA text (KenLM interop)")
    args = p.parse_args(argv)
    if not args.model_config:
        args.model_config = args.data_config   # LM needs only the data YAML
    config = load_config(args)

    phone_f, char_f, p2p, pin, tap = build_featurizers(config)
    feat = phone_f if args.unit == "phone" else char_f

    from tensorflowasr_tpu_torch.utils.ngram_lm import (
        NGramLM,
        train_ngram_lm,
    )

    if args.lm:
        if args.lm.endswith(".arpa"):
            lm = NGramLM.from_arpa(args.lm, feat.token_to_index,
                                   feat.num_classes)
        else:
            lm = NGramLM.load(args.lm)
    else:
        lists = args.lists
        if not lists:
            sc = config.section("speech_config")
            lists = sc["train_list"]
            lists = [lists] if isinstance(lists, str) else lists
        if not lists:
            print("no --lists and no train_list in config", file=sys.stderr)
            return 2
        seqs = _to_ids(_lines(lists), args.unit, phone_f, char_f, p2p, pin,
                       tap)
        if not seqs:
            print("no usable transcript lines", file=sys.stderr)
            return 2
        lm = train_ngram_lm(seqs, feat.num_classes, order=args.order,
                            discount=args.discount)
        lm.save(args.output)
        print(f"trained order-{lm.order} {args.unit} LM on "
              f"{len(seqs)} lines -> {args.output} "
              f"(table cap {len(lm.key1)}, probes {lm.n_probe}, "
              f"train ppl {lm.perplexity(seqs[:2000]):.2f})")

    if args.arpa_out:
        # vocab index -> token string; the appended CTC blank has no
        # token — it never appears in transcripts, label it <blank>
        id_to_token = [feat.index_to_token.get(i, "<blank>")
                       for i in range(feat.num_classes)]
        lm.to_arpa(args.arpa_out, id_to_token)
        print(f"ARPA export -> {args.arpa_out}")

    if args.eval_lists:
        seqs = _to_ids(_lines(args.eval_lists), args.unit, phone_f, char_f,
                       p2p, pin, tap)
        print(f"held-out perplexity ({len(seqs)} lines): "
              f"{lm.perplexity(seqs):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
