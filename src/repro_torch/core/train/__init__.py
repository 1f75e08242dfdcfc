"""Search machinery beyond the plain loop: the chain population."""
from .population import (ChainState, PBTDraws, PopulationConfig,
                         PopulationController, chain_counts, draw_pbt,
                         init_chain_state, init_temperatures, pbt_rows,
                         population_generator, update_chain_bests)

__all__ = ["ChainState", "PBTDraws", "PopulationConfig",
           "PopulationController", "chain_counts", "draw_pbt",
           "init_chain_state", "init_temperatures", "pbt_rows",
           "population_generator", "update_chain_bests"]
