"""One module per model architecture: how the program under test is built
from a configuration file whose ``architecture`` key names the module.
``matbench/program.py`` documents what each exposes."""
