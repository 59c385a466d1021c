"""Shared DPB / reference-list management (encoder + decoder).

Ports the reference semantics:
  - ref list construction: xeve_picman_refp_init (xeve_picman.c:271-393)
  - marking: pic_marking (xeve_picman.c:57-97) — temporal-id-0 triggered
  - POC derivation from decode order + temporal id: xeve_poc_derivation
    (xeve_util.c:250-281)

DPB entries are dicts with keys: poc, tid, ref (bool), list0_poc,
y_pad/u_pad/v_pad, map_mv.
"""
from __future__ import annotations

import numpy as np

MAX_ACTIVE_REF = 5  # XEVE_MAX_NUM_ACTIVE_REF_FRAME


def build_ref_lists(dpb, poc, tid, slice_type_b, slice_type_p, slice_type,
                    max_refs, last_intra_poc):
    """Returns (refp_l0, refp_l1)."""
    marked = [p for p in dpb if p.get("ref", True)]
    usable = [p for p in marked
              if not (poc >= last_intra_poc and p["poc"] < last_intra_poc)]
    usable.sort(key=lambda p: -p["poc"])
    past = [p for p in usable if p["poc"] < poc]                 # poc desc
    future = sorted([p for p in usable if p["poc"] > poc],
                    key=lambda p: p["poc"])                      # poc asc

    def build(first, second, constrain_first=True):
        out = []
        next_lid = max(tid - 1, 0)
        for p in first:
            if len(out) >= max_refs:
                break
            if not constrain_first or p["tid"] <= next_lid:
                out.append(p)
                next_lid = max(p["tid"] - 1, 0)
        next_lid = max(tid - 1, 0)
        for p in second:
            if len(out) >= max_refs:
                break
            if p["tid"] <= next_lid:
                out.append(p)
                next_lid = max(p["tid"] - 1, 0)
        return out

    if slice_type == slice_type_p:
        return build(past, [], constrain_first=(tid > 0)), []
    return build(past, future), build(future, past)


def dpb_mark_and_insert(dpb, pic, is_idr):
    """In-place DPB update for the incoming picture (already-decoded/encoded).
    pic must carry poc/tid/ref."""
    if is_idr:
        dpb.clear()
    elif pic["tid"] == 0:
        dpb[:] = [p for p in dpb if p["tid"] == 0]
        while len([p for p in dpb if p.get("ref", True)]) >= MAX_ACTIVE_REF:
            dpb.pop(0)
    dpb.append(pic)


class PocState:
    def __init__(self):
        self.poc = 0
        self.prev_poc_val = 0
        self.prev_doc_offset = 0

    def derive(self, is_idr, tid, log2_sub_gop):
        if is_idr:
            self.poc = 0
            self.prev_poc_val = 0
            self.prev_doc_offset = 0
            return 0
        sub_gop = 1 << log2_sub_gop
        if sub_gop <= 1:
            self.poc += 1
            return self.poc
        if tid == 0:
            self.poc = self.prev_poc_val + sub_gop
            self.prev_doc_offset = 0
            self.prev_poc_val = self.poc
            return self.poc
        doc_offset = (self.prev_doc_offset + 1) % sub_gop
        if doc_offset == 0:
            self.prev_poc_val += sub_gop
            expected_tid = 0
        else:
            expected_tid = 1 + int(np.log2(doc_offset))
        while tid != expected_tid:
            doc_offset = (doc_offset + 1) % sub_gop
            expected_tid = 0 if doc_offset == 0 else 1 + int(np.log2(doc_offset))
        self.poc = self.prev_poc_val + int(
            sub_gop * ((2.0 * doc_offset + 1) / (1 << tid) - 2))
        self.prev_doc_offset = doc_offset
        return self.poc


# GOP16 random-access structure (derived from xeve_tbl_slice_depth gop16 row
# + decide_normal_gop): per coding position within a sub-GOP, the frame depth.
# tid = depth - 1 (depth > 0).  slice_ref_flag = 0 at the deepest level.
RA_GOP16_DEPTHS = [1, 2, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5]


def ra_gop16_order(base_poc):
    """Coding order (poc, tid, is_ref) for one GOP16 sub-GOP starting after
    base_poc (i.e. pocs base+1 .. base+16)."""
    ps = PocState()
    ps.prev_poc_val = base_poc
    out = []
    for depth in RA_GOP16_DEPTHS:
        tid = depth - 1 if depth > 0 else 0
        poc = ps.derive(False, tid, 4)
        out.append((poc, tid, depth < 5))
    return out
