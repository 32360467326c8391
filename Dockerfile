# simplex_tpu web service (the reference's dockerfile role: python-slim,
# non-root user, production WSGI server on :5000).
FROM python:3.12-slim

ENV TZ=UTC \
    PYTHONUNBUFFERED=1

RUN apt-get update && apt-get install -y --no-install-recommends g++ \
    && rm -rf /var/lib/apt/lists/*

RUN useradd --create-home appuser
WORKDIR /home/appuser/app

COPY pyproject.toml ./
COPY simplex_tpu ./simplex_tpu
COPY web_app.py bench.py ./

# JAX with its CUDA plugin: run the container with a GPU attached
# (``docker run --gpus all``).
RUN pip install --no-cache-dir "jax[cuda12]" . gunicorn scipy

RUN chown -R appuser:appuser /home/appuser
USER appuser

EXPOSE 5000
# One worker process (threads for concurrent requests): a JAX process
# reserves most of the accelerator's memory, so a second one on the same
# card would fail to start.
CMD ["gunicorn", "--workers", "1", "--threads", "4", "--bind", "0.0.0.0:5000", "web_app:app"]
