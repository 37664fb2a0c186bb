"""Polishing engines (the framework's model families).

task 1 score_chain  — short-read chain correction        (score_chain.py)
task 2 kmer_count   — low-quality-region k-mer vote      (kmer_count.py)
task 3 snp_phase    — diploid SNP phasing (experimental) (snp_phase.py)
task 4 snp_valid    — SNP re-validation (experimental)   (snp_valid.py)
task 5 lgs_polish   — long-read consensus                (ctg_cns.py)
task 6 hifi_polish  — HiFi consensus                     (ctg_cns.py)
"""
