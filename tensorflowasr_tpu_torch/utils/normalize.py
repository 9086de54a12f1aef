"""Chinese text normalization for TTS/ASR corpora.

A copy of ``tensorflowasr_tpu/utils/normalize.py`` (pure host code; the
port imports nothing of the JAX package).

Clean-room re-design of the reference NSW normalizer
(augmentations/tts_for_asr/utils/normalize.py in Z-yq/TensorflowASR,
~720 LoC): converts non-standard words (numbers, dates, money, phones,
fractions, percentages, quantified amounts, IDs, times) in Chinese text
to spoken hanzi so synthesized/transcribed text matches the ASR
vocabulary. The pipeline is table-driven: an ordered list of
(name, regex, rewriter) rules applied in the reference's precedence
order (date -> money -> telephone -> fraction -> percentage -> range ->
quantifier -> digit-ID -> cardinal -> letter-2 particular):

- dates                 2021年5月1日 -> 二零二一年五月一日
- money                 5块3毛 -> 五块三毛, 200元 -> 两百元
- mobile / fixed phones 13812345678 -> 幺三八幺二三四五六七八 (*)
- fractions             3/4 -> 四分之三
- percentages           50% / 50％ -> 百分之五十
- ranges                3-5(个) -> 三到五(个)
- number + quantifier   123个 -> 一百二十三个 (full measure-word table)
- clock times           8:30 -> 八点三十分
- digit IDs (4+)        编号2021 -> 编号二零二一
- cardinals             3.5 -> 三点五, 200 -> 两百 (两-alternation as in
                        the reference's num2chn alt_two)
- letter context 二->2  B二C -> B2C (reference _particular)
- fullwidth ASCII -> halfwidth, CJK punctuation preserved

(*) deviation: the reference reads phone digits with 一; we use the
standard Mandarin telephone readout 幺, and apply it only in telephone
contexts (after 电话/手机/号/拨/传真 or an area-code/mobile pattern) —
other digit IDs read 一 exactly like the reference.
"""

from __future__ import annotations

import re
from typing import Callable, List, Tuple

_DIGITS = "零一二三四五六七八九"
_TEL_DIGITS = "零幺二三四五六七八九"
_UNITS_SMALL = ["", "十", "百", "千"]
_UNITS_BIG = ["", "万", "亿", "万亿"]


def digits_readout(num: str, telephone: bool = True) -> str:
    """Digit-by-digit readout; 1 -> 幺 in telephone style."""
    table = _TEL_DIGITS if telephone else _DIGITS
    return "".join(table[int(c)] if c.isdigit() else c for c in num)


def _four_digits_to_hanzi(n: int) -> str:
    """0 < n < 10000 -> hanzi with 十/百/千."""
    out = []
    digits = [int(c) for c in str(n)]
    length = len(digits)
    for i, d in enumerate(digits):
        unit = _UNITS_SMALL[length - 1 - i]
        if d == 0:
            if out and out[-1] != "零" and any(digits[i + 1:]):
                out.append("零")
        else:
            out.append(_DIGITS[d] + unit)
    return "".join(out)


def int_to_hanzi(n: int) -> str:
    """Integer -> hanzi numeral (standard reading, always 二)."""
    if n == 0:
        return "零"
    if n < 0:
        return "负" + int_to_hanzi(-n)
    groups: List[int] = []                       # low to high, base 10000
    while n > 0:
        n, rem = divmod(n, 10000)
        groups.append(rem)
    out = ""
    skipped_group = False
    for i in range(len(groups) - 1, -1, -1):
        rem = groups[i]
        if rem == 0:
            skipped_group = True
            continue
        # inner zero: within a group (100500 -> 十万零五百) or across a
        # skipped all-zero group (100002000 -> 一亿零二千)
        if out and (rem < 1000 or skipped_group):
            out += "零"
        skipped_group = False
        out += _four_digits_to_hanzi(rem) + _UNITS_BIG[i]
    # 一十X -> 十X for 10..19
    if out.startswith("一十"):
        out = out[1:]
    return re.sub("零+", "零", out)


#  二 -> 两 directly before 百/千/万/亿, when at the start or right after a
#  higher unit (NOT after 十 or another digit/零) — the reference's
#  num2chn alt_two condition (normalize.py:357-366)
_RE_LIANG = re.compile("(?<=[百千万亿])二(?=[百千万亿])|^二(?=[百千万亿])")


def number_to_hanzi(num: str, alt_two: bool = False) -> str:
    """'123', '3.5', '-2' -> hanzi. ``alt_two`` applies the reference's
    num2chn 两-alternation: 二 reads 两 directly before 百/千/万/亿 unless
    it follows 十 (200 -> 两百, 22 -> 二十二, 1212 -> 一千两百一十二)."""
    neg = num.startswith("-")
    if neg:
        num = num[1:]
    if "." in num:
        int_part, frac = num.split(".", 1)
        body = int_to_hanzi(int(int_part or "0")) + "点" + \
            digits_readout(frac, telephone=False)
    else:
        body = int_to_hanzi(int(num))
    if alt_two:
        body = _RE_LIANG.sub("两", body)
    return ("负" if neg else "") + body


def _cardinal(num: str) -> str:
    """In-text cardinal (reference Cardinal class: alt_two on)."""
    return number_to_hanzi(num, alt_two=True)


def to_halfwidth(text: str) -> str:
    out = []
    for ch in text:
        code = ord(ch)
        if code == 0x3000:
            out.append(" ")
        elif (0xFF10 <= code <= 0xFF19 or 0xFF21 <= code <= 0xFF3A
              or 0xFF41 <= code <= 0xFF5A):
            # fullwidth alphanumerics only — fullwidth punctuation (，！…)
            # is part of the punctuation vocab and must be preserved
            out.append(chr(code - 0xFEE0))
        else:
            out.append(ch)
    return "".join(out)


# The Chinese measure-word (量词) inventory of the reference's
# COM_QUANTIFIERS (normalize.py:32-38) — a closed-class vocabulary list,
# reproduced as data.
_QUANTIFIERS = (
    "匹|张|座|回|场|尾|条|个|首|阙|阵|网|炮|顶|丘|棵|只|支|袭|辆|挑|担|颗|"
    "壳|窠|曲|墙|群|腔|砣|座|客|贯|扎|捆|刀|令|打|手|罗|坡|山|岭|江|溪|钟|"
    "队|单|双|对|出|口|头|脚|板|跳|枝|件|贴|针|线|管|名|位|身|堂|课|本|页|"
    "家|户|层|丝|毫|厘|分|钱|两|斤|担|铢|石|钧|锱|忽|(?:千|毫|微)克|毫|厘|"
    "分|寸|尺|丈|里|寻|常|铺|程|(?:千|分|厘|毫|微)米|撮|勺|合|升|斗|石|盘|"
    "碗|碟|叠|桶|笼|盆|盒|杯|钟|斛|锅|簋|篮|盘|桶|罐|瓶|壶|卮|盏|箩|箱|煲|"
    "啖|袋|钵|年|月|日|季|刻|时|周|天|秒|分|旬|纪|岁|世|更|夜|春|夏|秋|冬|"
    "代|伏|辈|丸|泡|粒|颗|幢|堆|条|根|支|道|面|片|张|颗|块"
)

#  编号/型号/代号/账号/工号/学号 are IDs (一-readout), not dialed numbers
_TEL_CONTEXT = re.compile(r"(?:电话|手机|号码|(?<![编型代账工学])号|拨打|拨|"
                          r"传真|致电|热线)[是为:：]?\s?$")


def _digit_id(num: str, prefix: str) -> str:
    """Digit-string readout: 幺-style only in telephone context."""
    tel = bool(_TEL_CONTEXT.search(prefix))
    return digits_readout(num, telephone=tel)


# -- rewriters (match objects -> hanzi) -------------------------------------

def _rw_date(m: re.Match) -> str:
    out = ""
    if m.group("year"):
        out += digits_readout(m.group("year"), telephone=False) + "年"
    if m.group("month"):
        out += _cardinal(m.group("month")) + "月"
    if m.group("day"):
        out += _cardinal(m.group("day")) + m.group("daysuf")
    return out


def _rw_money(m: re.Match) -> str:
    out = _cardinal(m.group("amount")) + (m.group("approx") or "") + \
        m.group("unit")
    if m.group("sub"):
        out += _DIGITS[int(m.group("sub"))] + (m.group("subunit") or "")
    return out


def _rw_mobile(m: re.Match) -> str:
    out = ""
    if m.group("cc"):
        out += digits_readout(m.group("cc").lstrip("+").strip())
    return out + digits_readout(m.group("num"))


def _rw_fixed(m: re.Match) -> str:
    return digits_readout(m.group("area")) + digits_readout(m.group("num"))


def _rw_fraction(m: re.Match) -> str:
    return _cardinal(m.group(2)) + "分之" + _cardinal(m.group(1))


def _rw_percent(m: re.Match) -> str:
    return "百分之" + _cardinal(m.group(1))


def _rw_range(m: re.Match) -> str:
    return _cardinal(m.group(1)) + "到" + _cardinal(m.group(2))


def _rw_quantified(m: re.Match) -> str:
    return _cardinal(m.group("num")) + (m.group("approx") or "") + \
        m.group("quant")


def _rw_time(m: re.Match) -> str:
    out = _cardinal(m.group(1)) + "点"
    minute = int(m.group(2))
    if minute:
        out += _cardinal(str(minute)) + "分"
    else:
        out += "整"
    if m.group(3):
        out += _cardinal(str(int(m.group(3)))) + "秒"
    return out


def _rw_number(m: re.Match) -> str:
    return _cardinal(m.group(1))


# ordered rule table — precedence mirrors NSWNormalizer.normalize()
# (normalize.py:611-694): specific patterns consume their digits before
# general ones see them
_RULES: List[Tuple[str, re.Pattern, Callable[[re.Match], str]]] = [
    ("date", re.compile(
        r"(?<!\d)(?:(?P<year>(?:19|20)\d{2}|[089]\d)年)?"
        r"(?:(?P<month>1[0-2]|0?[1-9])月)(?:(?P<day>3[01]|[12]?\d)"
        r"(?P<daysuf>[日号]))?|(?<!\d)(?P<year2>(?:19|20)\d{2}|[089]\d)年"),
     None),  # dispatched specially below (year-only alternative)
    ("money", re.compile(
        r"(?<![\d.])(?P<amount>\d+(?:\.\d+)?)(?P<approx>[多余几]?)"
        r"(?P<unit>(?:亿|千万|百万|万|千|百)?[元块]|[角毛分])"
        r"(?:(?P<sub>\d)(?P<subunit>[角毛分])?)?(?!\d)"), _rw_money),
    ("mobile", re.compile(
        r"(?<!\d)(?P<cc>\+?86 ?)?(?P<num>1[3-9]\d{9})(?!\d)"), _rw_mobile),
    ("fixed_phone", re.compile(
        r"(?<!\d)(?P<area>0(?:10|2[1-3]|[3-9]\d{2}))-?"
        r"(?P<num>[1-9]\d{6,7})(?!\d)"), _rw_fixed),
    ("fraction", re.compile(r"(?<!\d)(\d{1,6})/(\d{1,6})(?!\d)"),
     _rw_fraction),
    ("percent", re.compile(r"(\d+(?:\.\d+)?)%"), _rw_percent),
    ("range", re.compile(r"(?<!\d)(\d+)[-~](\d+)(?!\d)"), _rw_range),
    ("time", re.compile(r"(?<!\d)([01]?\d|2[0-3]):([0-5]\d)(?::([0-5]\d))?"
                        r"(?!\d)"), _rw_time),
    ("quantified", re.compile(
        r"(?<![\d.])(?P<num>\d+(?:\.\d+)?)(?P<approx>[多余几]?)"
        r"(?P<quant>" + _QUANTIFIERS + r")"), _rw_quantified),
    ("digit_id", re.compile(r"(?<![\d.])(\d{4,32})(?![\d.])"), None),
    ("decimal", re.compile(r"(?<![\d.])(-?\d+\.\d+)(?![\d.])"), _rw_number),
    ("integer", re.compile(r"(?<![\d.])(-?\d+)(?![\d.])"), _rw_number),
]

# letters around 二 -> '2' (reference _particular, normalize.py:600-609)
_RE_PARTICULAR = re.compile(r"([a-zA-Z]+)二([a-zA-Z]+)")


def _rw_date_dispatch(m: re.Match) -> str:
    if m.group("year2"):
        return digits_readout(m.group("year2"), telephone=False) + "年"
    return _rw_date(m)


def normalize_text(text: str) -> str:
    """Normalize one line of Chinese text (main entry)."""
    t = to_halfwidth(text).replace("％", "%")
    for name, pattern, rw in _RULES:
        if name == "date":
            t = pattern.sub(_rw_date_dispatch, t)
        elif name == "digit_id":
            # context-sensitive: needs the text before the match
            out, pos = [], 0
            for m in pattern.finditer(t):
                out.append(t[pos:m.start()])
                out.append(_digit_id(m.group(1), t[:m.start()]))
                pos = m.end()
            out.append(t[pos:])
            t = "".join(out)
        else:
            t = pattern.sub(rw, t)
    return _RE_PARTICULAR.sub(lambda m: m.group(1) + "2" + m.group(2), t)
