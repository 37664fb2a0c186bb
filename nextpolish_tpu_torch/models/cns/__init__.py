"""Long-read / HiFi consensus engine (tasks 5/6) — lib/ctg_cns.c rebuilt.

Pieces:
  tags.py    read CIGARs -> align-tag columns (t_pos, delta, q_base) with
             anchor trimming, window clipping, coverage/l_ins/l_del tracks
  msa.py     tag triples -> per-tag (pp, ppp) link tables (update_msa)
  dp.py      second-order link DP + read-type tie rules + traceback
  lq.py      low-quality region detection and candidate extraction
  poa.py     partial-order alignment consensus (lib/dag.c)
  refine.py  sudoseed re-alignment iterations + splice
  window.py  window loop + overlap stitching -> ctg_cns_contig
"""
