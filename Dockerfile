# Reproducible environment for npore-tpu (parity with the reference's
# container story, /root/reference/Dockerfile — ubuntu + toolchain + the
# package installed; here the stack is JAX/XLA instead of Cython, and the
# native C++ host kernels build lazily at import via g++ + ctypes).
#
#   docker build -t npore-tpu .
#   docker run --rm npore-tpu python -m pytest tests/ -q        # hermetic CPU
#   docker run --rm npore-tpu npore-realign --help
#
# This image is the CPU test environment. To run on an NVIDIA GPU, use an
# image that has the CUDA toolkit (nvcc, for the kernel that builds at first
# use from npore_tpu/ops/cuda/dp_tb.cu) and install jax[cuda12]==0.9.0;
# the engine then picks the GPU kernel by itself.
FROM python:3.12-slim-bookworm AS base

ENV LANG=C.UTF-8 LC_ALL=C.UTF-8 PIP_NO_CACHE_DIR=1 \
    JAX_PLATFORMS=cpu

# g++/make: the ctypes-bound native kernels (npore_tpu/native/*.cpp)
# compile on first import; zlib headers for any local BGZF tooling.
RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make zlib1g-dev \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/npore-tpu

# pinned runtime + test deps (the image is the reproducibility story;
# pyproject keeps loose ranges for library consumers)
RUN pip install "jax==0.9.0" "numpy<3" pytest pytest-xdist matplotlib

COPY pyproject.toml README.md ./
COPY npore_tpu ./npore_tpu
COPY guppy5_stats ./guppy5_stats
COPY scripts ./scripts
COPY tests ./tests
COPY bench.py chip_smoke.py __graft_entry__.py ./

RUN pip install -e . && python -c "import npore_tpu, jax; \
    from npore_tpu.native import get_lib; \
    assert get_lib() is not None, 'native kernel build failed'"

CMD ["python", "-m", "pytest", "tests/", "-q"]

# ---------------------------------------------------------------------------
# Opt-in stage with the REAL external pipeline tools: the
# build container this repo is developed in has no network access and no
# samtools/minimap2/bcftools binaries, so the L5 shell pipelines
# (scripts/align.sh, realign_pipeline.sh) are exercised in-suite against
# functional mocks (tests/mock_tools/). Wherever this image CAN be built
# with network, this stage makes the real integration testable:
#
#   docker build --target realtools -t npore-tpu:realtools .
#   docker run --rm npore-tpu:realtools bash scripts/align.sh --help
#   docker run --rm npore-tpu:realtools bash -c \
#       'cd /opt/npore-tpu && samtools view tests/data/reads.bam | head -2'
#
# (clair3/whatshap/hap.py are not Debian-packaged; the realign_pipeline
# stages that need them still require the reference's conda recipe,
# /root/reference's Dockerfile — documented gap, see PARITY.md.)
FROM base AS realtools
RUN apt-get update && apt-get install -y --no-install-recommends \
        samtools minimap2 bcftools tabix \
    && rm -rf /var/lib/apt/lists/*
