"""Read kind `long`: long reads over a haploid genome
(simgen.simulate_case), at the configuration's read and draft rates."""
from npbench import simgen


def simulate(seed: int, lens: list, config: dict) -> simgen.SimCase:
    r = config["reads"]
    return simgen.simulate_case(
        seed, len(lens), lens, r["depth"], read_len=tuple(r["read_len"]),
        sub=r["sub"], ins=r["ins"], dele=r["del"],
        draft_sub=config["draft_sub"], rev_frac=r["rev_frac"],
        draft_ins=config.get("draft_ins", 0.0),
        draft_del=config.get("draft_del", 0.0))
