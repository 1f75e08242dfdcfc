"""Training layer: the (G, B) episode loop, the chain population, the
curriculum sampler and the corpus trainer."""
from .loop import (BestTracker, EpisodePrefetcher, EpisodeRunner,
                   WindowStream, make_chain_streams, window_weights)
from .population import (ChainState, PBTDraws, PopulationConfig,
                         PopulationController, chain_counts, draw_pbt,
                         init_chain_state, init_temperatures, pbt_rows,
                         population_generator, update_chain_bests)
from .sampler import CurriculumSampler

__all__ = ["BestTracker", "EpisodePrefetcher", "EpisodeRunner",
           "WindowStream", "make_chain_streams", "window_weights",
           "ChainState", "PBTDraws", "PopulationConfig",
           "PopulationController", "chain_counts", "draw_pbt",
           "init_chain_state", "init_temperatures", "pbt_rows",
           "population_generator", "update_chain_bests",
           "CurriculumSampler", "CurriculumTrainer", "CorpusTrainResult"]


def __getattr__(name):
    # curriculum.py imports hsdag, which imports this package: resolve it
    # lazily so ``repro_torch.core.hsdag`` can import the loop first.
    if name in ("CurriculumTrainer", "CorpusTrainResult"):
        from . import curriculum
        return getattr(curriculum, name)
    raise AttributeError(name)
