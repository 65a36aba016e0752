"""Greedy people assembly from PAF pair scores (host-side, numpy).

The benchmark's frozen copy of the port's plain host arithmetic
(`openpose_tpu_torch/ops/assembly.py`), which follows the OpenPose
reference's bodyPartConnectorBase.cpp: connections ranked by score, greedy
union of people, subset-count and mean-score filters, BODY_25 foot
discount.  The reference decode calls `connect_body_parts`.  It imports
nothing of the program, so a later change to the program's assembly is
judged against this copy.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def paf_scores_to_connections(
        pair_scores: np.ndarray, peaks: np.ndarray,
        pairs: np.ndarray) -> List[Tuple[float, float, int, int, int]]:
    """-> list of (total_score, paf_score, pair_index, index_a, index_b),
    sorted descending; index_a/b are 1-based peak slots as in the reference.

    Fully vectorized (one mask + nonzero over [P, K, K] instead of a Python
    loop per pair): candidates appear in (pair, a, b) row-major order like
    the reference's append loop, and the stable argsort on -total preserves
    that order among ties, so the greedy consumer sees the exact reference
    sequence (pafPtrIntoVector's std::sort is on total_score only)."""
    k = pair_scores.shape[1]
    counts = np.minimum(np.rint(peaks[:, 0, 0]).astype(np.int64), k)
    # slice to the true max count first: the mask work is O(P * kmax^2),
    # not O(P * K^2) at the static 127-slot budget (assembly only ever
    # reads the [:count_a, :count_b] corner)
    kmax = int(counts[np.asarray(pairs).reshape(-1)].max()) \
        if counts.size else 0
    if kmax <= 0:
        return []
    pair_scores = pair_scores[:, :kmax, :kmax]
    slot = np.arange(kmax)
    na = counts[pairs[:, 0]][:, None, None]          # [P,1,1]
    nb = counts[pairs[:, 1]][:, None, None]
    valid = (pair_scores > 1e-6) \
        & (slot[None, :, None] < na) & (slot[None, None, :] < nb)
    pi, ia, ib = np.nonzero(valid)
    if pi.size == 0:
        return []
    score = pair_scores[pi, ia, ib].astype(np.float64)
    total = score + 0.1 * peaks[pairs[pi, 0], ia + 1, 2] \
                  + 0.1 * peaks[pairs[pi, 1], ib + 1, 2]
    order = np.argsort(-total, kind="stable")
    return list(zip(total[order].tolist(), score[order].tolist(),
                    pi[order].tolist(), (ia[order] + 1).tolist(),
                    (ib[order] + 1).tolist()))


def connections_to_people(
        connections, peaks: np.ndarray, pairs: np.ndarray,
        num_parts: int) -> List[Tuple[List[int], float]]:
    """Greedy assembly; returns [(person_vector, score)].

    person_vector has num_parts+1 slots: slot p holds a *flat index* into
    peaks.reshape(-1) pointing at the score component of the chosen peak
    (0 = unset), and the last slot holds the keypoint count — the same
    encoding the reference uses so downstream logic matches line for line.
    """
    max_peaks = peaks.shape[1] - 1
    # flat PYTHON list: the loop below does one scalar read per connection,
    # and numpy scalar indexing (boxing a np.float32 each time) measured
    # ~3x slower than list access on the few-hundred-connection frames the
    # host tail sees
    peaks_flat = np.asarray(peaks, np.float64).reshape(-1).tolist()
    pairs_list = [(int(a), int(b)) for a, b in np.asarray(pairs)]
    people: List[Tuple[List[int], float]] = []
    person_slots: List[List[int]] = []    # slots owned by each person row
    person_assigned = [-1] * (num_parts * max_peaks)
    to_remove: set = set()

    for _total, paf_score, pair_index, index_a, index_b in connections:
        part_a, part_b = pairs_list[pair_index]
        idx_score_a = (part_a * (max_peaks + 1) + index_a) * 3 + 2
        idx_score_b = (part_b * (max_peaks + 1) + index_b) * 3 + 2
        a_slot = part_a * max_peaks + index_a - 1
        b_slot = part_b * max_peaks + index_b - 1
        a_assigned = person_assigned[a_slot]
        b_assigned = person_assigned[b_slot]

        if a_assigned < 0 and b_assigned < 0:
            row = [0] * (num_parts + 1)
            row[part_a] = idx_score_a
            row[part_b] = idx_score_b
            row[-1] = 2
            score = peaks_flat[idx_score_a] + peaks_flat[idx_score_b] \
                + paf_score
            person_assigned[a_slot] = person_assigned[b_slot] = len(people)
            person_slots.append([a_slot, b_slot])
            people.append((row, score))
        elif (a_assigned >= 0) != (b_assigned >= 0):
            assigned1 = a_assigned if a_assigned >= 0 else b_assigned
            part2 = part_b if a_assigned >= 0 else part_a
            idx_score2 = idx_score_b if a_assigned >= 0 else idx_score_a
            slot2 = b_slot if a_assigned >= 0 else a_slot
            row, score = people[assigned1]
            if row[part2] == 0:
                row[part2] = idx_score2
                row[-1] += 1
                people[assigned1] = (row, score + peaks_flat[idx_score2]
                                     + paf_score)
                person_assigned[slot2] = assigned1
                person_slots[assigned1].append(slot2)
        elif a_assigned == b_assigned:  # circular/redundant PAF
            row, score = people[a_assigned]
            people[a_assigned] = (row, score + paf_score)
        else:  # merge two people if keypoint sets are disjoint
            assigned1 = min(a_assigned, b_assigned)
            assigned2 = max(a_assigned, b_assigned)
            row1, score1 = people[assigned1]
            row2, score2 = people[assigned2]
            complementary = all(
                not (row1[p] > 0 and row2[p] > 0) for p in range(num_parts))
            if complementary:
                for p in range(num_parts):
                    if row1[p] == 0:
                        row1[p] = row2[p]
                row1[-1] += row2[-1]
                people[assigned1] = (row1, score1 + score2 + paf_score)
                to_remove.add(assigned2)
                for s in person_slots[assigned2]:
                    person_assigned[s] = assigned1
                person_slots[assigned1] += person_slots[assigned2]
                person_slots[assigned2] = []

    keep = [i for i in range(len(people)) if i not in to_remove]
    return [people[i] for i in keep]


def _keypoint_discount(row: List[int], first: int, last: int,
                       minimum: int) -> int:
    """getKeypointCounter (bodyPartConnectorBase.cpp:78-98): if more than
    `minimum` keypoints in [first, last), return minimum - count (<=0)."""
    cnt = sum(1 for p in range(first, last) if row[p] > 0)
    return minimum - cnt if cnt > minimum else 0


def filter_people(people, num_parts: int, min_subset_cnt: int,
                  min_subset_score: float,
                  maximize_positives: bool) -> List[int]:
    """Return indices of valid people (removePeopleBelowThresholdsAndFillFaces,
    bodyPartConnectorBase.cpp:721-885; the >=135-part face-merge branch is
    inapplicable to the supported models)."""
    valid: List[int] = []
    for i, (row, score) in enumerate(people):
        counter = row[-1]
        if not maximize_positives and (num_parts == 25 or num_parts > 70):
            new_counter = counter + _keypoint_discount(row, 19, 25, 0)
            # Remove duplicated standalone legs without upper torso
            if new_counter != counter and new_counter <= 4:
                continue
            counter = new_counter
        if counter >= min_subset_cnt and score / counter >= min_subset_score:
            valid.append(i)
    if not valid and not maximize_positives:
        return filter_people(people, num_parts, min_subset_cnt,
                             min_subset_score, True)
    return valid


def people_to_array(people, valid: List[int], peaks: np.ndarray,
                    num_parts: int, num_pairs: int,
                    scale_factor: float) -> Tuple[np.ndarray, np.ndarray]:
    """-> (keypoints [people, parts, 3], scores [people])."""
    peaks_flat = peaks.reshape(-1)
    n = len(valid)
    keypoints = np.zeros((n, num_parts, 3), np.float32)
    scores = np.zeros((n,), np.float32)
    inv = 1.0 / (num_parts + num_pairs)
    for out_i, i in enumerate(valid):
        row, score = people[i]
        for p in range(num_parts):
            idx = row[p]
            if idx > 0:
                keypoints[out_i, p, 0] = peaks_flat[idx - 2] * scale_factor
                keypoints[out_i, p, 1] = peaks_flat[idx - 1] * scale_factor
                keypoints[out_i, p, 2] = peaks_flat[idx]
        scores[out_i] = score * inv
    return keypoints, scores


def connect_body_parts(
        pair_scores: np.ndarray, peaks: np.ndarray, pairs: np.ndarray,
        num_parts: int, min_subset_cnt: int, min_subset_score: float,
        scale_factor: float,
        maximize_positives: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Full host tail: scores + peaks -> (keypoints, scores).

    pair_scores: [P, K, K] (one frame), peaks: [parts(+bkg), K+1, 3].
    """
    connections = paf_scores_to_connections(pair_scores, peaks, pairs)
    people = connections_to_people(connections, peaks, pairs, num_parts)
    valid = filter_people(people, num_parts, min_subset_cnt, min_subset_score,
                          maximize_positives)
    return people_to_array(people, valid, peaks, num_parts, pairs.shape[0],
                           scale_factor)
