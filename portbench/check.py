"""Decides ``correct``: what the timed path served against the plain
reference.

For each checked frame (a sample of the window's batches, drawn from the
seed) the program's packed result gives its peaks, and its ``Human``s its
people. Each cell's ``limits/<cell>.json`` names the numbers it
compares; the others are reported. Three stages are judged:

- peaks (preprocess, forward, NMS, top-K, refinement): the reference
  runs its own float32 forward on the frame and finds its own peaks
  (``reference/decode.py``); a program peak and a reference peak of the
  same part pair up when both are within ``RADIUS`` pixels on each axis,
  nearest first. ``peaks_unmatched_pct`` is the share of peaks, of both
  sides, left without a partner; ``peaks_moved_pct`` the share of pairs
  whose coordinates differ at all (the widest score gap of a pair,
  ``peak_score_gap``, is reported: it swings from seed to seed by as
  much as it separates bf16 from int8);
- people (the PAF branch, limb scores, matching, merge, packing): the
  reference assembles people from the program's own peaks and the
  reference's PAF maps. A served person and a reference person pair up
  when they have the same parts at the same pixels with the same part
  scores. ``person_score_gap`` is the median, over the people of both
  sides, of the gap between a person's score and its partner's; a person
  without a partner counts as a gap of its whole score. The served PAF is
  bf16, and a limb score at a tie of the greedy match goes either way: one
  such flip at a neck or a hip regroups whole people, so that a tenth of
  the people (a third on some seeds) go unpaired in sound runs
  (``people_unmatched_pct``, reported), while the median stays a gap of
  paired people until half go unpaired. The PAF's values along the limbs
  set the gaps, a wrong field leaves people unpaired;
- the conversion (the packed result to ``Human``s): the reference turns
  the person table that the timed path copied back into people
  (``reference/decode.py::people_from_table``); ``people_unconverted``
  counts the frames whose served people differ from it at all (exact).

The people stage starts from the program's peaks, the peak stage checks
those peaks apart; and every frame's people from the reference's own
peaks are reported beside them (``own_*``: people a frame, and the share
of frames whose people have the same parts at the same pixels), not
compared.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from portbench.reference import decode as ref_decode

__all__ = ["RADIUS", "judge", "people_of", "unpack_peaks", "unpack_table"]

#: pixels (of the input frame) by which paired peaks may differ on each
#: axis: half a cell of the stride-8 maps
RADIUS = 4


def unpack_peaks(packed: np.ndarray, k: int = ref_decode.K):
    """The port's packed ``[B, L]`` rows -> peaks (xy ``[B, 18 K, 2]``,
    score ``[B, 18 K]``, valid ``[B, 18 K]``); the packing is the
    decode's ``pack_result`` (xy, score, valid, person table, flags)."""
    n = 18 * k
    packed = np.asarray(packed, dtype=np.float32)
    b = packed.shape[0]
    xy = packed[:, :2 * n].reshape(b, n, 2).astype(np.int64)
    score = packed[:, 2 * n:3 * n]
    valid = packed[:, 3 * n:4 * n] > 0.5
    return xy, score, valid


def unpack_table(packed: np.ndarray, k: int = ref_decode.K,
                 cap: int = ref_decode.CAP):
    """The port's packed ``[B, L]`` rows -> their person tables (subset
    ``[B, cap, 20]``, person_valid ``[B, cap]``), after the peaks."""
    packed = np.asarray(packed, dtype=np.float32)
    b, start = packed.shape[0], 4 * 18 * k
    subset = packed[:, start:start + 20 * cap].reshape(b, cap, 20)
    return subset, packed[:, start + 20 * cap:start + 21 * cap] > 0.5


def people_of(humans) -> List[tuple]:
    """A frame's ``Human``s as ``(score, ((part, x, y, part score), ...))``
    in the order served (tuples pass through)."""
    out = []
    for h in humans:
        if isinstance(h, tuple):
            out.append(h)
            continue
        out.append((h.score, tuple(
            (p, bp.x, bp.y, bp.score) for p, bp in sorted(h.body_parts.items()))))
    return out


def _pair_people(got, want):
    """People paired by their parts (part, pixel, part score) -> (the
    unpaired people of both sides, [score gap] of the pairs)."""
    left: Dict[tuple, list] = {}
    for score, parts in want:
        left.setdefault(parts, []).append(score)
    unpaired, gaps = [], []
    for score, parts in got:
        if left.get(parts):
            gaps.append(abs(score - left[parts].pop(0)))
        else:
            unpaired.append(("served", score, parts))
    unpaired += [("reference", s, parts) for parts, scores in left.items()
                 for s in scores]
    return unpaired, gaps


def _keypoints(people) -> list:
    """People without their scores: (part, x, y) of each part."""
    return [tuple(part[:3] for part in parts) for _, parts in people]


def _pair_peaks(a_xy, a_s, b_xy, b_s):
    """Greedy nearest pairing within RADIUS -> (unpaired count, [(score
    gap, largest coordinate difference)] of the pairs)."""
    if not len(a_xy) or not len(b_xy):
        return len(a_xy) + len(b_xy), []
    d = np.abs(a_xy[:, None, :] - b_xy[None, :, :]).max(-1)
    ia, ib = np.nonzero(d <= RADIUS)
    order = np.argsort(d[ia, ib], kind="stable")
    used_a, used_b, gaps = set(), set(), []
    for i, j in zip(ia[order], ib[order]):
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        gaps.append((abs(float(a_s[i]) - float(b_s[j])),
                     int(np.abs(a_xy[i] - b_xy[j]).max())))
    return len(a_xy) + len(b_xy) - 2 * len(gaps), gaps


def _quantile(values, q: float) -> float:
    """The ``q`` quantile of ``values`` by nearest rank (0 if empty)."""
    if not values:
        return 0.0
    ordered = sorted(values)
    return float(ordered[min(len(ordered) - 1, int(q * len(ordered)))])


def judge(served: Dict[int, tuple], pool_index, ref_peaks, ref_paf,
          frame_hw) -> dict:
    """``served``: batch index -> ((xy, score, valid, table), people
    lists) of the checked batches, ``table`` the packed person tables
    (:func:`unpack_table`) or None where the program packs none;
    ``pool_index(batch, row)`` -> the pool frame;
    ``ref_peaks``: the reference's own (xy, score, valid) over the pool;
    ``ref_paf``: ``[pool, 38, H, W]`` float32 numpy."""
    h, w = frame_hw
    unpaired = total = frames = own_equal = unconverted = 0
    people_unpaired = people_total = 0
    gaps, person_gaps, people, own_people = [], [], [], []
    peaks_per_part = []
    assembled: Dict[tuple, list] = {}
    own_cache: Dict[int, list] = {}
    first = ""
    for i, ((xy, score, valid, table), humans) in sorted(served.items()):
        for row in range(len(humans)):
            p = pool_index(i, row)
            frames += 1
            v = valid[row].reshape(18, -1)
            rv = ref_peaks[2][p].reshape(18, -1)
            pxy, rxy = xy[row].reshape(18, -1, 2), ref_peaks[0][p].reshape(18, -1, 2)
            ps, rs = score[row].reshape(18, -1), ref_peaks[1][p].reshape(18, -1)
            for part in range(18):
                n_un, g = _pair_peaks(pxy[part][v[part]], ps[part][v[part]],
                                      rxy[part][rv[part]], rs[part][rv[part]])
                unpaired += n_un
                total += int(v[part].sum() + rv[part].sum())
                gaps += g
            peaks_per_part.append(int(v.sum(1).max()))
            key = (p, xy[row].tobytes(), score[row].tobytes(), valid[row].tobytes())
            if key not in assembled:
                assembled[key] = ref_decode.assemble(
                    xy[row], score[row], valid[row], ref_paf[p], h, w)
            ref = assembled[key]
            got = people_of(humans[row])
            if table is not None and got != ref_decode.people_from_table(
                    table[0][row], table[1][row], xy[row], score[row], h, w):
                unconverted += 1
                first = first or f"batch {i} frame {row}: not its table's people"
            lone, g = _pair_people(got, ref)
            people_unpaired += len(lone)
            people_total += len(got) + len(ref)
            person_gaps += 2 * g + [score for _, score, _ in lone]
            if lone and not first:
                first = f"batch {i} frame {row}: unpaired {lone[0]}"
            people.append(len(got))
            if p not in own_cache:
                own_cache[p] = ref_decode.assemble(
                    ref_peaks[0][p], ref_peaks[1][p], ref_peaks[2][p],
                    ref_paf[p], h, w)
            own = own_cache[p]
            own_people.append(len(own))
            own_equal += _keypoints(own) == _keypoints(got)
    return {
        "values": {
            "peaks_unmatched_pct": 100.0 * unpaired / max(total, 1),
            "peaks_moved_pct": 100.0 * sum(d > 0 for _, d in gaps)
            / max(len(gaps), 1),
            "person_score_gap": _quantile(person_gaps, 0.5),
            "people_unconverted": float(unconverted),
        },
        "people_unmatched_pct": 100.0 * people_unpaired / max(people_total, 1),
        "first_mismatch": first,
        "frames_checked": frames,
        "peak_score_gap": max((g for g, _ in gaps), default=0.0),
        "peaks_max_per_part": max(peaks_per_part, default=0),
        "people_mean": float(np.mean(people)) if people else 0.0,
        "people_max": max(people, default=0),
        "own_people_mean": float(np.mean(own_people)) if own_people else 0.0,
        "own_frames_equal_pct": 100.0 * own_equal / max(frames, 1),
    }

