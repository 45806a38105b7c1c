"""repro_torch.core — the paper's contribution: ε-private PIR schemes
behind the staged SchemeProtocol registry (DESIGN.md §Scheme protocol) and
the privacy-accounting calculus.

The per-scheme wire modules (chor/sparse) are internals of this package;
everything outside goes through the protocol (``build_scheme``/...) or the
``Scheme`` facade."""

from repro_torch.core import accounting, chor, protocol, sparse
from repro_torch.core.accounting import PrivacyBudget, epsilon_sparse
from repro_torch.core.private_embedding import PrivateEmbedding
from repro_torch.core.protocol import (
    Answers,
    ChorScheme,
    MultiQueries,
    Queries,
    SchemeProtocol,
    SparseScheme,
    as_protocol,
    build_scheme,
    register_scheme,
    registered_schemes,
    scheme_param_names,
    staged_retrieve,
    staged_retrieve_many,
)
from repro_torch.core.schemes import SCHEMES, Scheme, make_scheme

__all__ = [
    "Answers",
    "ChorScheme",
    "MultiQueries",
    "PrivacyBudget",
    "PrivateEmbedding",
    "Queries",
    "SCHEMES",
    "Scheme",
    "SchemeProtocol",
    "SparseScheme",
    "accounting",
    "as_protocol",
    "build_scheme",
    "epsilon_sparse",
    "make_scheme",
    "protocol",
    "register_scheme",
    "registered_schemes",
    "scheme_param_names",
    "staged_retrieve",
    "staged_retrieve_many",
]
