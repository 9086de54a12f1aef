"""Mandarin pinyin -> phone-unit inventory (initial/final split).

A copy of ``tensorflowasr_tpu/utils/phones.py`` (pure Python): the same rules
give the same maps and inventories.

The reference ships a fixed 1545-entry map (asr/configs/dict/
pinyin2phone.map -> 226-token phone.txt) that splits every toned pinyin
syllable into an initial + toned final, with pseudo-initials for
zero-initial syllables. This module GENERATES that inventory from rules,
so any corpus can be prepared without shipping the dictionary:

- real initials: b p m f d t n l g k h j q x zh ch sh r z c s
- pseudo-initials by syllable onset: ``aa`` (a-), ``ee`` (e-), ``oo``
  (o-), ``ii`` (y-), ``uu`` (w-), ``vv`` (yu-)
- apical vowels: zhi/chi/shi/ri -> final ``ix``; zi/ci/si -> ``iy``
- y-/w- surface forms fold back to medial finals (ya->ia, you->iu,
  wei->ui, wen->un, ...); yu- forms to v-finals (yu->v, yuan->van,
  yue->ve, yun->vn)
- j/q/x + u- spellings are underlying v-finals (ju->j v, jun->j vn,
  juan->j van, jue->j ve)
- the tone digit (1-5, 5 = neutral) stays on the final only.

Verified against the reference map: the rules reproduce its split for
every entry (tests/test_phones.py), modulo a handful of typos in the
shipped file (er5 -> "ee er2", weng2/3 -> "ueng1") that the rules render
consistently instead.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

# longest-match-first real initials
INITIALS: Tuple[str, ...] = (
    "zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l",
    "g", "k", "h", "j", "q", "x", "r", "z", "c", "s",
)

PSEUDO_INITIALS: Tuple[str, ...] = ("aa", "ee", "oo", "ii", "uu", "vv")

# legal toneless finals (standard table + apical ix/iy)
FINALS: Tuple[str, ...] = (
    "a", "ai", "an", "ang", "ao", "e", "ei", "en", "eng", "er", "i",
    "ia", "ian", "iang", "iao", "ie", "in", "ing", "iong", "iu", "ix",
    "iy", "o", "ong", "ou", "u", "ua", "uai", "uan", "uang", "ueng",
    "ui", "un", "uo", "v", "van", "ve", "vn",
)

# surface y-/w- syllable -> underlying final (exceptions first, then the
# productive y+V -> i+V / w+V -> u+V rules in split_base)
_Y_EXCEPTIONS = {"yi": "i", "yin": "in", "ying": "ing", "you": "iu",
                 "yo": "iu", "yu": "v", "yue": "ve", "yuan": "van",
                 "yun": "vn"}
_W_EXCEPTIONS = {"wu": "u", "wei": "ui", "wen": "un"}

# standard Mandarin syllable table (v-spellings for ü after l/n). Used by
# full_syllable_table(); rare-but-attested syllables included — harmless
# as map keys that never occur.
_SYLLABLES_BY_INITIAL = {
    "": "a o e ai ei ao ou an en ang eng er n",
    "y": "yi ya ye yao you yan yin yang ying yong yu yue yuan yun yo",
    "w": "wu wa wo wai wei wan wen wang weng",
    "b": "ba bo bai bei bao ban ben bang beng bi bie biao bian bin bing bu",
    "p": "pa po pai pei pao pou pan pen pang peng pi pie piao pian pin "
         "ping pu",
    "m": "ma mo me mai mei mao mou man men mang meng mi mie miao miu mian "
         "min ming mu",
    "f": "fa fo fei fou fan fen fang feng fu",
    "d": "da de dai dei dao dou dan den dang deng dong di dia die diao "
         "diu dian din ding du duo dui duan dun",
    "t": "ta te tai tao tou tan tang teng tong ti tie tiao tian ting tu "
         "tuo tui tuan tun",
    "n": "na ne nai nei nao nou nan nen nang neng nong ni nie niao niu "
         "nian nin niang ning nu nuo nuan nun nv nve",
    "l": "la lo le lai lei lao lou lan lang leng long li lia lie liao liu "
         "lian lin liang ling lu luo luan lun lv lve",
    "g": "ga ge gai gei gao gou gan gen gang geng gong gu gua guo guai "
         "gui guan gun guang",
    "k": "ka ke kai kei kao kou kan ken kang keng kong ku kua kuo kuai "
         "kui kuan kun kuang",
    "h": "ha he hai hei hao hou han hen hang heng hong hu hua huo huai "
         "hui huan hun huang",
    "j": "ji jia jie jiao jiu jian jin jiang jing jiong ju jue juan jun",
    "q": "qi qia qie qiao qiu qian qin qiang qing qiong qu que quan qun",
    "x": "xi xia xie xiao xiu xian xin xiang xing xiong xu xue xuan xun",
    "zh": "zha zhe zhi zhai zhei zhao zhou zhan zhen zhang zheng zhong "
          "zhu zhua zhuo zhuai zhui zhuan zhun zhuang",
    "ch": "cha che chi chai chao chou chan chen chang cheng chong chu "
          "chua chuo chuai chui chuan chun chuang",
    "sh": "sha she shi shai shei shao shou shan shen shang sheng shu "
          "shua shuo shuai shui shuan shun shuang",
    "r": "re ri rao rou ran ren rang reng rong ru rua ruo rui ruan run",
    "z": "za ze zi zai zei zao zou zan zen zang zeng zong zu zuo zui "
         "zuan zun",
    "c": "ca ce ci cai cao cou can cen cang ceng cong cu cuo cui cuan "
         "cun",
    "s": "sa se si sai sao sou san sen sang seng song su suo sui suan "
         "sun",
}


def full_syllable_table() -> List[str]:
    """All standard base (toneless) pinyin syllables."""
    out: List[str] = []
    for syls in _SYLLABLES_BY_INITIAL.values():
        out.extend(syls.split())
    return out


def split_base(base: str) -> Tuple[str, str]:
    """Toneless syllable -> (initial_or_pseudo, toneless final).

    Raises ValueError for strings that are not pinyin syllables.
    """
    if not base or not base.isascii() or not base.isalpha():
        raise ValueError(f"not a pinyin syllable: {base!r}")
    if base in ("n", "ng"):  # syllabic nasal 嗯 reads as "en"
        return "ee", "en"
    if base in ("zhi", "chi", "shi", "ri"):
        return base[:-1], "ix"
    if base in ("zi", "ci", "si"):
        return base[0], "iy"
    def checked(ini: str, fin: str) -> Tuple[str, str]:
        if fin not in FINALS:
            raise ValueError(f"not a pinyin syllable: {base!r}")
        return ini, fin

    if base[0] == "y":
        if base in _Y_EXCEPTIONS:
            fin = _Y_EXCEPTIONS[base]
            return ("vv" if fin[0] == "v" else "ii"), fin
        return checked("ii", "i" + base[1:])
    if base[0] == "w":
        return checked("uu", _W_EXCEPTIONS.get(base, "u" + base[1:]))
    if base[0] in "aeo":
        return checked({"a": "aa", "e": "ee", "o": "oo"}[base[0]], base)
    for ini in INITIALS:
        if base.startswith(ini) and len(base) > len(ini):
            fin = base[len(ini):]
            if ini in ("j", "q", "x") and fin[0] == "u":
                fin = "v" + fin[1:]
            elif ini in ("n", "l") and fin.startswith("ue"):
                fin = "ve" + fin[2:]  # nue/lue spelling variants of nve/lve
            return checked(ini, fin)
    raise ValueError(f"not a pinyin syllable: {base!r}")


def split_pinyin(syllable: str) -> List[str]:
    """Toned pinyin (TONE3, e.g. ``zhong1``) -> phone units
    (``['zh', 'ong1']``). Toneless input gets the neutral tone 5."""
    base, tone = syllable, "5"
    if base and base[-1].isdigit():
        base, tone = base[:-1], base[-1]
    if tone not in "12345":
        raise ValueError(f"bad tone in {syllable!r}")
    ini, fin = split_base(base.lower())
    return [ini, fin + tone]


def build_pinyin2phone(syllables: Iterable[str] | None = None,
                       tones: Sequence[str] = ("1", "2", "3", "4", "5"),
                       ) -> Dict[str, List[str]]:
    """pinyin2phone map for the given base syllables (default: the full
    standard table) x tones. Same key/value format the reference map
    file uses (``long5 -> [l, ong5]``)."""
    bases = list(syllables) if syllables is not None \
        else full_syllable_table()
    mapping: Dict[str, List[str]] = {}
    for base in bases:
        for tone in tones:
            mapping[base + tone] = split_pinyin(base + tone)
    return mapping


def phone_inventory(mapping: Dict[str, List[str]]) -> List[str]:
    """Sorted unique phone units used by a map: initials first, then
    toned finals (the reference's phone.txt body layout)."""
    inis = sorted({v[0] for v in mapping.values()})
    fins = sorted({v[1] for v in mapping.values()})
    return inis + fins
