from setuptools import find_packages, setup

setup(
    name="streaming-vlm-tpu",
    version="0.1.0",
    packages=find_packages(include=["streaming_vlm_tpu*", "streaming_vlm_tpu_torch*"]),
    python_requires=">=3.10",
)
