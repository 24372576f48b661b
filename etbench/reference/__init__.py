"""The plain reference: PyTorch written out from the published models, with
no kernel, cache or padding. It imports nothing of the program under test
and takes nothing the program computed: it reads the same checkpoint file
and the same generated inputs."""
