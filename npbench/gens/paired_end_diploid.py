"""Read kind `paired_end_diploid`: paired-end short reads from the two
haplotypes of a diploid genome, half the depth from each.

Per contig, from one numpy `default_rng(seed)` in this order: hap1, a
random sequence; hap2, hap1 with a substitution at each base with
probability `reads.het_sub` (heterozygous SNVs only, so hap2 keeps
hap1's coordinates); the draft, hap1 with the configuration's
substitutions and then its single-base indels; then simgen's read pairs
over hap1 (fragments `a<tid>_<k>`) and over hap2 (`b<tid>_<k>`), each at
`reads.depth / 2`, both aligned through hap1's truth-to-draft edit map.
The draft carries hap1's allele at every heterozygous site; `truths`
holds hap1.  Records are sorted by (tid, pos).
"""
import numpy as np

from npbench import simgen


def haplotypes(rng, length: int, het_sub: float) -> tuple:
    """(hap1, hap2) of one contig, as simulate draws them."""
    hap1 = rng.choice(simgen.BASES, length)
    return hap1, simgen._mutate(rng, hap1, het_sub)


def simulate(seed: int, lens: list, config: dict) -> simgen.SimCase:
    r = config["reads"]
    rng = np.random.default_rng(seed)
    ins, dele = config.get("draft_ins", 0.0), config.get("draft_del", 0.0)
    names, truths, drafts, records = [], [], [], []
    for tid, length in enumerate(lens):
        hap1, hap2 = haplotypes(rng, int(length), r["het_sub"])
        draft, dmap = simgen._mutate(rng, hap1, config["draft_sub"]), None
        if ins or dele:
            draft, dmap = simgen.draft_indels(rng, draft, ins, dele)
        names.append(f"ctg{tid}")
        truths.append(hap1.tobytes())
        drafts.append(draft.tobytes())
        for hap, tag in ((hap1, "a"), (hap2, "b")):
            records += simgen._pair_records(
                rng, hap, tid, r["depth"] / 2, r["read_len"],
                (r["insert_mean"], r["insert_sd"]), r["sub"], r["ins"],
                r["del"], f"{tag}{tid}_", dmap=dmap)
    records.sort(key=lambda rec: (rec["tid"], rec["pos"]))
    return simgen.SimCase(names, truths, drafts, records)
