from .synthetic import (cifar_like, imdb_like, casa_like,  # noqa: F401
                        lm_batch, lm_tokens)
from .partition import (iid_partition, dirichlet_partition,  # noqa: F401
                        FederatedLoader)
