# Container image for the experiment pipeline (CPU parity mode).
# GPU runs install jax[cuda12] instead of jax[cpu].
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
    build-essential \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /home/felicity
COPY pyproject.toml README.md ./
COPY multimodal_trajectory_modeling_tpu ./multimodal_trajectory_modeling_tpu
COPY framework ./framework
COPY framework_extended ./framework_extended
COPY util ./util
COPY drivers ./drivers
COPY posthoc ./posthoc
COPY tests ./tests
COPY Makefile bench.py __graft_entry__.py ./

RUN pip install --no-cache-dir "jax[cpu]" && pip install --no-cache-dir -e ".[reference]"

CMD ["make", "all"]
