"""Search machinery beyond the plain loop: the chain population and the
(G, B) episode loop of joint training."""
from .loop import (BestTracker, EpisodeRunner, WindowStream,
                   make_chain_streams, window_weights)
from .population import (ChainState, PBTDraws, PopulationConfig,
                         PopulationController, chain_counts, draw_pbt,
                         init_chain_state, init_temperatures, pbt_rows,
                         population_generator, update_chain_bests)

__all__ = ["BestTracker", "EpisodeRunner", "WindowStream",
           "make_chain_streams", "window_weights", "ChainState", "PBTDraws",
           "PopulationConfig", "PopulationController", "chain_counts",
           "draw_pbt", "init_chain_state", "init_temperatures", "pbt_rows",
           "population_generator", "update_chain_bests"]
