"""Trace post-processors: a copy of `rfhe_tpu/trace/analyze.py` (pure `re`).

The post-processors (L6) have the semantics of the reference's
analyze_trace.py / sum_trace.py (profile_framewk/build/), generalized to any
ROI tag and both 'us' and 'µs' spellings.

  collapse_kernel_runs   analyze_trace.py:14-93 — inside an ROI block, merge
                         consecutive [NTT] lines into one and subtract the
                         merged child time from the next parent op's cost
                         (self-time attribution).
  summarize_roi          sum_trace.py:14-98 — aggregate per-tag kernel costs
                         inside the ROI, collapsing NTT runs into their
                         parents' self-time, and report per-tag shares.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Iterable, List

_US = r"(?:µs|us)"


def _res(roi: str, child: str):
    start = re.compile(rf"^frontend: {re.escape(roi)}$")
    end = re.compile(rf"^frontend: {re.escape(roi)}\[(\d+)\s+microseconds\]$|"
                     rf"^{re.escape(roi)}\[(\d+)\s+microseconds\]$")
    kid = re.compile(rf"^\[{re.escape(child)}\] total cost\s+(\d+)\s+{_US}$")
    cost = re.compile(rf"^\[([^\]]+)\] total cost\s+(\d+)\s+{_US}")
    return start, end, kid, cost


def collapse_kernel_runs(lines: Iterable[str], roi: str = "ROTATE",
                         child: str = "NTT") -> List[str]:
    """Merge consecutive child-kernel lines within an ROI block; subtract the
    merged child time from the cost line that follows the run."""
    start_re, end_re, ntt_re, cost_re = _res(roi, child)
    cost_line_re = re.compile(rf"^(.*total cost\s+)(\d+)(\s+{_US}.*)$")
    out: List[str] = []
    in_block = False
    block: List[str] = []
    start_line = ""
    in_seq = False
    seq_sum = 0
    for raw in lines:
        line = raw.rstrip("\n")
        if start_re.match(line):
            in_block = True
            start_line = line
            block = []
            in_seq = False
            seq_sum = 0
            continue
        if in_block and end_re.match(line):
            if in_seq:
                block.append(f"[{child}] total cost {seq_sum} us")
            out.append(start_line)
            out.extend(block)
            out.append(line)
            in_block = False
            continue
        if in_block:
            m = ntt_re.match(line)
            if m:
                seq_sum = (seq_sum + int(m.group(1))) if in_seq else int(m.group(1))
                in_seq = True
            else:
                if in_seq:
                    block.append(f"[{child}] total cost {seq_sum} us")
                    m_cost = cost_line_re.match(line)
                    if m_cost:
                        pre, val, suf = m_cost.groups()
                        line = f"{pre}{int(val) - seq_sum}{suf}"
                    in_seq = False
                    seq_sum = 0
                block.append(line)
    if in_block:
        if in_seq:
            block.append(f"[{child}] total cost {seq_sum} us")
        out.append(start_line)
        out.extend(block)
    return out


def summarize_roi(lines: Iterable[str], roi: str = "ROTATE",
                  child: str = "NTT",
                  all_blocks: bool = False) -> Dict:
    """Per-tag totals inside ROI blocks with NTT-run collapsing and self-time
    attribution.  Returns {"roi_total_us", "ops_total_us", "per_tag",
    "shares_of_roi", "child_share_of_ops"}."""
    start_re, end_re, ntt_re, cost_re = _res(roi, child)
    costs: Dict[str, int] = defaultdict(int)
    roi_sum = 0
    in_block = False
    in_seq = False
    seq_sum = 0
    for raw in lines:
        line = raw.rstrip("\n")
        if start_re.match(line):
            in_block = True
            in_seq = False
            seq_sum = 0
            continue
        m_end = end_re.match(line) if in_block else None
        if m_end:
            if in_seq:
                costs[child] += seq_sum
                in_seq = False
                seq_sum = 0
            roi_sum += int(m_end.group(1) or m_end.group(2))
            in_block = False
            if not all_blocks:
                break
            continue
        if not in_block:
            continue
        m = ntt_re.match(line)
        if m:
            seq_sum += int(m.group(1))
            in_seq = True
            continue
        m = cost_re.match(line)
        if m:
            tag, val = m.group(1), int(m.group(2))
            if in_seq:
                costs[child] += seq_sum
                costs[tag] += val - seq_sum
                in_seq = False
                seq_sum = 0
            else:
                costs[tag] += val
    ops_total = sum(costs.values())
    return {
        "roi_total_us": roi_sum,
        "ops_total_us": ops_total,
        "per_tag": dict(costs),
        "shares_of_roi": {t: (v / roi_sum if roi_sum else 0.0)
                          for t, v in costs.items()},
        "child_share_of_ops": (costs.get(child, 0) / ops_total
                               if ops_total else 0.0),
    }
