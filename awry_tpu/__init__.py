"""awry_tpu: an accelerator-resident FM-index engine in JAX.

Brand-new framework with the capabilities of the AWRY reference library
(FASTA/FASTQ -> FM-index; exact-match count/locate over DNA/RNA/protein),
re-designed for an accelerator: the index lives in device memory as structure-of-arrays
bit-planes, rank is a vectorized masked-popcount over thousands of queries,
and batches scale over device meshes with jax.sharding.

Public surface mirrors the reference's (src/lib.rs:2-10):
  Alphabet            <- SymbolAlphabet
  FmBuildArgs         <- FmBuildArgs
  FmIndexData         <- FmIndex (host form)
  build_index         <- FmIndex::new
  save / load         <- FmIndex::{save, load} (native artifact + .awry)
  FmQueryEngine       <- count_string/locate_string/parallel_* (device form)
"""

from .alphabet import Alphabet, Symbol
from .build.builder import build_from_records, build_index
from .fm_index import FmIndex, LocalizedSequencePosition, SearchRange
from .host_engine import count, count_batch, locate, locate_batch
from .index import FmBuildArgs, FmIndexData
from .io.artifact import load_artifact, save_artifact
from .io.awry_format import load_awry, save_awry

__version__ = "0.1.0"

__all__ = [
    "Alphabet",
    "Symbol",
    "FmIndex",
    "SearchRange",
    "LocalizedSequencePosition",
    "FmBuildArgs",
    "FmIndexData",
    "build_index",
    "build_from_records",
    "count",
    "count_batch",
    "locate",
    "locate_batch",
    "save_awry",
    "load_awry",
    "save_artifact",
    "load_artifact",
]
