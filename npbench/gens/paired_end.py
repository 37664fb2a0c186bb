"""Read kind `paired_end`: paired-end short reads over a haploid genome
(simgen.simulate_short_case), at the configuration's read and draft
rates."""
from npbench import simgen


def simulate(seed: int, lens: list, config: dict) -> simgen.SimCase:
    r = config["reads"]
    return simgen.simulate_short_case(
        seed, lens, r["depth"], read_len=r["read_len"],
        insert=(r["insert_mean"], r["insert_sd"]), sub=r["sub"],
        ins=r["ins"], dele=r["del"], draft_sub=config["draft_sub"],
        draft_ins=config.get("draft_ins", 0.0),
        draft_del=config.get("draft_del", 0.0))
