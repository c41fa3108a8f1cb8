"""``python -m dllama_tpu_torch inference|perplexity ...``"""

import sys

from .serve.cli import main

sys.exit(main())
