"""The work of the cheap phase (detect .. vote) that a chunk's reads need,
whatever implements it: (int32 operations, float32 operations, bytes),
with the window widths and seed width of the configuration.

Bytes: each sample of the chunk once at 4 bytes (the f32 signal the chunk
holds, and the int32 Q-format samples the kernel reads), the distinct
bucket-boundary words and index entries (two int32 words each) the reads'
valid seeds probe, each surviving anchor's target position out (4 bytes),
nine int32 counters a read out.

Operations: a sample's windowed sums (4 w int32, w = ``tstat_window``),
its integer boundary terms (12 int32), the score's conversions and IEEE
division (4 float32) and the peak pick's maxima and tests (4 r float32,
r = ``peak_window``); an event's quantization and seed hash (2 * seed width
+ 16 int32); a valid seed's bucket lookup (24 int32); a probed entry's key
and count test and its two votes (12 int32).
"""


def count(work, mars_config):
    w, r = mars_config["tstat_window"], mars_config["peak_window"]
    seed_w = mars_config["seed_width"]
    samples = work["samples"]
    int_ops = (samples * (4 * w + 12)
               + work["events"] * (2 * seed_w + 16)
               + work["valid_seeds"] * 24 + work["probes"] * 12)
    fp_ops = samples * (4 + 4 * r)
    nbytes = (4 * samples + 4 * work["bucket_words"]
              + 8 * work["entries"] + 4 * work["anchors"]
              + 9 * 4 * work["reads"])
    return int_ops, fp_ops, nbytes
