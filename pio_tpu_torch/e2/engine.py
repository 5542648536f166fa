"""e2 engine-building helpers — parity naming for the reference e2 library.

Reference e2/src/main/scala/org/apache/predictionio/e2/engine/:
CategoricalNaiveBayes.scala, MarkovChain.scala, BinaryVectorizer.scala.
Counterpart of ``pio_tpu.e2.engine``. The implementations live in
pio_tpu_torch.ops / pio_tpu_torch.e2.vectorizer; this module
re-exports them under the e2 names engine templates import.
"""

from pio_tpu_torch.ops.naive_bayes import (
    CategoricalNBModel,
    categorical_nb_train,
)
from pio_tpu_torch.ops.markov import MarkovChainModel, markov_chain_train
from pio_tpu_torch.e2.vectorizer import BinaryVectorizer

__all__ = [
    "CategoricalNBModel",
    "categorical_nb_train",
    "MarkovChainModel",
    "markov_chain_train",
    "BinaryVectorizer",
]
