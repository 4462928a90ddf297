"""The model library: the JAX package's ``predictionio_tpu.models`` names,
bound to the port's classes."""

from predictionio_tpu_torch.models.als import (
    ALSConfig,
    ALSModel,
    ALSScorer,
    CheckpointedALSModel,
    train_als,
)
from predictionio_tpu_torch.models.binary_vectorizer import BinaryVectorizer
from predictionio_tpu_torch.models.cooccurrence import (
    CooccurrenceModel,
    cooccurrence_matrix,
    cross_occurrence_matrix,
    llr_cross_scores,
    llr_scores,
    train_cooccurrence,
)
from predictionio_tpu_torch.models.markov_chain import MarkovChainModel, train_markov_chain
from predictionio_tpu_torch.models.naive_bayes import (
    CategoricalNBModel,
    MultinomialNBModel,
    train_categorical_nb,
    train_multinomial_nb,
)
from predictionio_tpu_torch.models.random_forest import (
    RandomForestModel,
    RFConfig,
    train_random_forest,
)
from predictionio_tpu_torch.models.sequential import (
    SASRecConfig,
    SASRecModel,
    train_sasrec,
)

__all__ = [
    "ALSConfig",
    "ALSModel",
    "ALSScorer",
    "BinaryVectorizer",
    "CategoricalNBModel",
    "CheckpointedALSModel",
    "CooccurrenceModel",
    "MarkovChainModel",
    "MultinomialNBModel",
    "RFConfig",
    "RandomForestModel",
    "SASRecConfig",
    "SASRecModel",
    "cooccurrence_matrix",
    "cross_occurrence_matrix",
    "llr_cross_scores",
    "llr_scores",
    "train_als",
    "train_categorical_nb",
    "train_cooccurrence",
    "train_markov_chain",
    "train_multinomial_nb",
    "train_random_forest",
    "train_sasrec",
]
