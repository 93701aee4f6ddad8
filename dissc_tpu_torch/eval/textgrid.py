"""Minimal Praat TextGrid reader (``dissc_tpu.eval.textgrid``, copied: pure Python).

Replaces the ``textgrid`` pip package the reference uses for MFA
alignment metrics (``eval.py:14,105-129``).  Supports the long ("ooTextFile")
IntervalTier format MFA emits; tiers are indexable (``grid[0]`` = words,
``grid[1]`` = phones for MFA output) and intervals expose
``minTime``/``maxTime``/``mark``/``duration()``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List


@dataclasses.dataclass
class Interval:
    minTime: float
    maxTime: float
    mark: str

    def duration(self) -> float:
        return self.maxTime - self.minTime


@dataclasses.dataclass
class IntervalTier:
    name: str
    intervals: List[Interval]

    def __iter__(self):
        return iter(self.intervals)

    def __len__(self):
        return len(self.intervals)

    def __getitem__(self, i):
        return self.intervals[i]


class TextGrid:
    def __init__(self, tiers: List[IntervalTier], maxTime: float):
        self.tiers = tiers
        self.maxTime = maxTime

    def __getitem__(self, i) -> IntervalTier:
        return self.tiers[i]

    def __len__(self):
        return len(self.tiers)

    @classmethod
    def fromFile(cls, path: str) -> "TextGrid":
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            text = f.read()
        return cls.fromString(text)

    @classmethod
    def fromString(cls, text: str) -> "TextGrid":
        def fnum(pat, s):
            m = re.search(pat, s)
            return float(m.group(1)) if m else 0.0

        max_time = fnum(r"xmax\s*=\s*([\d.eE+-]+)", text.split("item", 1)[0])
        tiers: List[IntervalTier] = []
        # split into tier blocks: item [1]: ... item [2]: ...
        blocks = re.split(r"item\s*\[\d+\]\s*:", text)[1:]
        for block in blocks:
            name_m = re.search(r'name\s*=\s*"([^"]*)"', block)
            name = name_m.group(1) if name_m else ""
            intervals = []
            for im in re.finditer(
                r"intervals\s*\[\d+\]\s*:\s*"
                r"xmin\s*=\s*([\d.eE+-]+)\s*"
                r"xmax\s*=\s*([\d.eE+-]+)\s*"
                r'text\s*=\s*"([^"]*)"',
                block,
            ):
                intervals.append(Interval(float(im.group(1)), float(im.group(2)), im.group(3)))
            tiers.append(IntervalTier(name, intervals))
        return cls(tiers, max_time)
