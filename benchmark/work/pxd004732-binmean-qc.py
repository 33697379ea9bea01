"""Work model of ``pxd004732-binmean-qc``: the least bytes and operations
the card must spend on a job, from the job's problem sizes (the
reference's ``sizes``), whatever kernels implement it.  Each input byte
is read once and each output byte written once:

- the binned mean: each member's deduplicated in-range peak (one per
  member and bin) brings its intensity and one byte marking where its
  (cluster, bin) run starts (the host's sorted pass knows the runs);
  each kept run's mean goes out as float32; one addition per peak and
  one division per kept run;
- the QC cosine: each member's binned vector (a float32 bin key and a
  float32 value per nonzero bin) and each representative's, once, come
  in; one float32 cosine per member goes out; a multiply-add per member
  bin (dot product and norm), one per representative bin for its norm,
  and a few per member to finish its cosine.
"""

from benchmark.peaks import VALUE_BYTES


def work(sizes: dict, precision: str) -> dict:
    v = VALUE_BYTES[precision]
    mean_bytes = sizes["member_bins"] * (v + 1) + sizes["kept_runs"] * 4
    mean_flops = sizes["member_bins"] + sizes["kept_runs"]
    qc_bytes = ((sizes["qc_member_bins"] + sizes["qc_rep_bins"]) * 8
                + sizes["qc_pairs"] * 4)
    qc_flops = (4 * sizes["qc_member_bins"] + 2 * sizes["qc_rep_bins"]
                + 4 * sizes["qc_pairs"])
    return {"bytes": mean_bytes + qc_bytes, "flops": mean_flops + qc_flops}
