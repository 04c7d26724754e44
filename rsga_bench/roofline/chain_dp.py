"""The chaining DP's work that a chunk's reads need, whatever implements
it: (int32 operations, float32 operations, bytes), counted over the
anchors that survive the filters (the first min(anchors, max_anchors) of a
read), never over a padded width.

A predecessor weighed (anchor i weighs min(i, band) of them, ``work``'s
``dp_pairs``): 8 int32 operations (the two differences, four bounds tests,
the gap's difference and the skip's minimum) and 7 float32 ones (the two
conversions, the gap and skip terms as two fused multiply-adds, the live
test, the select, the running best).  An anchor: 3 int32 (its diagonal,
two selects) and 3 float32 (the score, its floor, the select).  Bytes: an
anchor's query and target position in (8) and its score and start
diagonal out (8).
"""


def count(work, mars_config):
    pairs, anchors = work["dp_pairs"], work["dp_anchors"]
    return 8 * pairs + 3 * anchors, 7 * pairs + 3 * anchors, 16 * anchors
