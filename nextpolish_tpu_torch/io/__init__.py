"""Host-side genomics IO substrate: FASTA/FASTQ, 2-bit codec, BAM/BGZF."""
