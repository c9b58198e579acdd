"""The paper's synthetic datasets (``synthetic``), with their random draws
as inputs or from a ``torch.Generator``."""
from repro_torch.data.synthetic import (MixtureDraws, gaussian_mixture,
                                        initial_centroid_groups,
                                        paper_dataset_3000,
                                        paper_dataset_15000)

__all__ = ["MixtureDraws", "gaussian_mixture", "initial_centroid_groups",
           "paper_dataset_3000", "paper_dataset_15000"]
